"""Measurement tools of the port: most run on a CUDA card; the two scaling
harnesses also run on the CPU."""
