"""Transport pieces of the port: per-port token buckets (:mod:`rate`)."""
