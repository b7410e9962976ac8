"""Lab benches of the port, each named after its counterpart in the
repo's `benchmarks/`."""
