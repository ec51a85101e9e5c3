"""Multi-device scaling over jax.sharding.Mesh."""
