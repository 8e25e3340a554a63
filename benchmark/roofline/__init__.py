"""Each configuration's operation and byte counts, frozen with the benchmark."""
