"""Device ops: the GF(2^8) coding kernel and batched BLAKE3 (CUDA, with
plain PyTorch versions), their numpy / pure-Python oracles, batch
bucketing, dispatch telemetry and the kernel build."""
