"""Multi-device scaling demo: dp x sp mesh, halo exchange, distributed FFT.

Needs at least two devices: the GPUs of one host, or on a CPU-only machine
8 virtual devices (the same mesh the test suite uses). Demonstrates the
three sharded routes:

1. ``blur_sharded_u8``   — the fused band engine per shard, reflect-aware
   ``ppermute`` halo exchange (multi-hop for kernels wider than a shard),
   uint8 end to end.
2. ``blur_fft_sharded``  — the distributed-FFT decomposition: shard-local
   batched rFFTs + ONE ``all_to_all`` reshard between the two 1-D passes.
3. AUTO sharding         — ``blur_u8`` transparently shards ANY batch of
   >= 2 frames (indivisible sizes pad-and-crop; spare devices shard rows
   when the batch is smaller than the device count) and sp-shards single
   frames above ``DeviceSpec.auto_sp_min_px`` over all devices.

Usage: python examples/multichip.py
"""

from __future__ import annotations

import os

if __name__ == "__main__":
    # 8 virtual CPU devices for CPU-only machines, requested BEFORE jax
    # initializes (the GPU backend, where present, is unaffected)
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main() -> None:
    from blur_algorithms import blur_u8, oracle
    from blur_algorithms.ops.plan import make_plan
    from blur_algorithms.parallel import (
        blur_fft_sharded_u8,
        blur_sharded_u8,
        make_mesh,
    )

    if len(jax.devices()) < 2:
        raise SystemExit(
            f"needs >= 2 devices, found {len(jax.devices())} "
            f"{jax.devices()[0].platform} device(s)"
        )

    n = len(jax.devices())
    print(f"devices: {n} x {jax.devices()[0].device_kind}")
    sp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(dp=n // sp, sp=sp)
    print(f"mesh: dp={n // sp} x sp={sp}")

    rng = np.random.default_rng(0)
    h, w, sigma = 256, 384, 8.0
    batch = (rng.random((2 * (n // sp), h, w, 3)) * 255).astype(np.uint8)
    plan = make_plan((h, w), sigma)
    want = oracle.blur_u8(batch[0], sigma)

    for name, fn in [
        ("fused + ppermute halos", blur_sharded_u8),
        ("distributed FFT (all_to_all)", blur_fft_sharded_u8),
    ]:
        out = np.asarray(fn(jnp.asarray(batch), plan, mesh))
        d = np.abs(out[0].astype(int) - want.astype(int)).max()
        print(f"{name:32s} max |err| vs oracle: {d}")

    if n > 1:
        auto_batch = batch[:n]
        out = np.asarray(blur_u8(jnp.asarray(auto_batch), sigma))
        d = np.abs(out[0].astype(int) - want.astype(int)).max()
        print(f"{'AUTO dp-sharded blur_u8':32s} max |err| vs oracle: {d}")


if __name__ == "__main__":
    main()
