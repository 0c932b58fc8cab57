from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
