"""Host-side helpers of the port (``tree``: pytrees in JAX's leaf order)."""
