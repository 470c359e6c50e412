"""The check against the JAX package compares top-level names whole."""

from benchmark.harness import guard


def test_top_level_names_compared_whole():
    mods = ["nbody_tpu_torch", "nbody_tpu_torch.ops.p3m", "numpy", "jaxtyping", "flaxen"]
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods + ["nbody_tpu.ops", "jax", "jaxlib.xla_client",
                                          "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "nbody_tpu.ops"]
