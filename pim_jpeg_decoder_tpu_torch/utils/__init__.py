"""Config, logging and stage timers (copies of the JAX package's), and
measurement helpers for the card."""
