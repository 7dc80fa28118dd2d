"""PyTorch/CUDA port of the SeedFlood JAX package `repro`; entry point: `repro_torch.dtrain.runner.run`."""
