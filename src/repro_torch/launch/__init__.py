"""Entry points: the multi-tenant SNN server."""
