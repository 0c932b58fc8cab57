"""PyTorch/CUDA port of the auto-scaling HTCondor pool.

The provisioning loop (schedd queue -> Collector negotiation ->
Provisioner deficits -> Kubernetes backends) lives in `repro_torch.core`
and `repro_torch.workload`; negotiation's water-fill runs on a
hand-written Hopper kernel (`repro_torch.kernels.waterfill`).  This
package imports PyTorch and NumPy only.
"""
