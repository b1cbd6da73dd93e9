"""Command-line tools and profiling helpers of the port."""
