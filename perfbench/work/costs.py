"""(bytes, FLOPs) of one call of the port's SSD backward kernel, frozen
here so that the benchmark's yardstick stays as it is when the program
changes.  Each input byte is counted read once and each output byte
written once; the FLOPs are those the call's inputs need."""
from __future__ import annotations


def ssd_bwd_flops(S: int, chunk: int, H: int, P: int, N: int, B: int = 1,
                  G: int = 1) -> int:
    """The backward's causal FLOPs: per chunk and group the scores once,
    per head the masked products of the key side (dx, dB) and the query
    side (dC), and the state terms (8PN a step)."""
    Q = min(chunk, S)
    total = 0
    for t0 in range(0, S, Q):
        L = min(Q, S - t0)
        total += (G * L * (L + 1) * N
                  + H * (L * (L + 1) * 2 * (N + P) + 8 * L * P * N))
    return B * total


def ssd_bwd_cost(B: int, S: int, H: int, P: int, G: int, N: int,
                 chunk: int, item: int, init: bool,
                 dfinal: bool) -> tuple[int, int]:
    """One SSD backward: x and dy, B and C per group, dt, A, D, the
    states the forward kept (every chunk's but a first one without an
    initial state, 4 bytes an element) and the final state's gradient
    once in; dx, dB, dC, ddt, dA, dD and the initial state's gradient
    once out."""
    n_chunks = -(-S // min(chunk, S))
    state = B * H * P * N * 4
    kept = (n_chunks - (not init)) * state
    nbytes = (3 * B * S * H * P * item + 4 * B * S * G * N * item
              + 2 * B * S * H * 4 + 4 * H * 4 + kept
              + (state if dfinal else 0) + (state if init else 0))
    return nbytes, ssd_bwd_flops(S, chunk, H, P, N, B, G)
