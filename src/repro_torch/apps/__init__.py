"""Application tiles of the port: echo and Reed-Solomon erasure coding."""
