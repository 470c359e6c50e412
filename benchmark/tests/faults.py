"""Faults planted under the benchmark's timed path, for the tests that see
``correct`` come out false: the program stepping as a broken program would.

  unchanged  a step that returns its state unchanged (update_many does nothing)
  half       the force of half of the bodies left out, the rest doubled
  exchange   the exchange of j-bodies between ranks left out, by ring or by
             all-gather (each rank's force from its own shard only)
  altered    one body's x altered by 1e-2 where the snapshot is read back
"""

from __future__ import annotations

import os


def apply(name: str) -> None:
    from nbody_tpu_torch.models.body_system import BodySystem

    if name == "unchanged":
        BodySystem.update_many = lambda self, steps, dt=None: None
    elif name == "half":
        accel, accel_jerk = BodySystem._accel, BodySystem._accel_jerk

        def halve(pos):
            p = pos.clone()
            p[pos.shape[0] // 2:, 3] = 0.0
            return p

        BodySystem._accel = lambda self, pos: 2.0 * accel(self, halve(pos))
        BodySystem._accel_jerk = lambda self, pos, vel: tuple(
            2.0 * t for t in accel_jerk(self, halve(pos), vel))
    elif name == "exchange":
        from nbody_tpu_torch.parallel import sharded

        def own_shard_only(mesh, shard):
            yield shard

        sharded._ring = own_shard_only
        sharded.all_gather_rows = lambda mesh, x: x
    elif name == "altered":
        positions = BodySystem.positions

        def altered(self):
            out = positions.fget(self)
            out[out.shape[0] // 3, 0] += 1e-2
            return out

        BodySystem.positions = property(altered)
    else:
        raise ValueError(f"unknown fault {name!r}")


def apply_from_env() -> None:
    name = os.environ.get("BENCHMARK_TEST_FAULT")
    if name:
        apply(name)
