"""Config and logging (copies of the JAX package's), stage timers (grown
from that package's copy: profiler ranges, thread CPU, card-timed
stages), and measurement helpers for the card."""
