"""Host-side utilities of the port: the native prefetching batch loader."""
