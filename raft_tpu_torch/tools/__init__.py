"""Tools of the port (``bench_diff``: the bench's regression gate)."""
