"""The single-image decode pipeline (host stages around the device decode)."""
