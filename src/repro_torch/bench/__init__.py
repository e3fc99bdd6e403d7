"""The reference's system benchmarks (`benchmarks/*_bench.py`) as drivers
of the port. Each runs on the CUDA card unless the caller names another
device, prints the reference's CSV rows, and writes its JSON only to a
path it is given."""
