"""Host helpers the codec layers call: metrics registry, error type,
supervised asyncio tasks, latency phase spans."""
