"""Measurement and checking tools of the port: the kernel tools run on a
CUDA card; the two scaling harnesses and the fuzz campaign also run on the
CPU; the host-decode tools (entropy_bench, prog_profile, src_ab, pgo_ab,
asan_drive, over host_corpus) need only g++."""
