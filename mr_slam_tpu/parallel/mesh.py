"""Device-mesh construction and sharding helpers.

The reference distributes work as one OS process per robot plus a hub
node, all glued by TCPROS (SURVEY.md §2.10). The equivalent here is a
`jax.sharding.Mesh` with two axes:

  robot — data parallelism over robots (per-robot odometry, descriptor
          databases, keyframe stores shard here);
  shard — intra-robot parallelism for large stores (keyframe index
          ranges, elevation-grid tiles).

Single-chip runs use a trivial 1x1 mesh so all pipeline code is written
once against named axes.
"""
from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROBOT_AXIS = "robot"
SHARD_AXIS = "shard"


def make_mesh(n_robots: int = 1, n_shards: int = 1, devices=None) -> Mesh:
    """Build a (robot, shard) mesh. Total devices must be >=
    n_robots * n_shards; excess devices are left out."""
    devices = list(devices if devices is not None else jax.devices())
    need = n_robots * n_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.array(devices[:need]).reshape(n_robots, n_shards)
    return Mesh(grid, (ROBOT_AXIS, SHARD_AXIS))


def single_device_mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), (ROBOT_AXIS, SHARD_AXIS))


def robot_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis = robot."""
    return NamedSharding(mesh, P(ROBOT_AXIS))


def robot_shard_sharding(mesh: Mesh) -> NamedSharding:
    """(robot, shard) on the two leading axes — keyframe stores."""
    return NamedSharding(mesh, P(ROBOT_AXIS, SHARD_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_tree(tree, sharding: NamedSharding):
    """device_put a whole pytree with one sharding."""
    return jax.device_put(tree, jax.tree.map(lambda _: sharding, tree))
