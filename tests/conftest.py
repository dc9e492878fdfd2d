import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# are exercised without GPUs. The `chip`-marked tests run on the card
# with JAX_PLATFORMS=cuda set explicitly; otherwise the platform is the
# CPU. jax may already be imported, so update the live config as well as
# the environment — this works as long as no backend has been
# initialized yet.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
