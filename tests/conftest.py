"""Test configuration: run on CPU with 8 virtual devices and f64 enabled.

Multi-chip sharding is validated on a virtual CPU mesh (the driver separately
dry-run-compiles the multi-chip path); parity tests need f64 because the
reference bindings use double (reference bindings/python/lib.cpp:30).
"""

import os

# Unit tests always run on the virtual CPU mesh; jax.config is updated
# after import as well, in case something imported jax before this file.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
