"""Logging, timing, debugging and analysis helpers. The JAX package's
``enable_compilation_cache`` has no counterpart: the port compiles nothing
that a cache could hold."""
