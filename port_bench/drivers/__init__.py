"""Window drivers: `drivers/<name>.py` defines `Driver` and `compare`."""
