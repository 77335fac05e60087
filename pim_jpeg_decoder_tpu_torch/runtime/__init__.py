"""Host runtime: batching and the producer/consumer decode engine."""
