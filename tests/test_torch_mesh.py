"""The port's mesh construction against the reference's: the pure (data,
model) shape-selection policy, submeshes over a pool of CPU slots (the
port's counterpart of the reference's forced host devices), and the
``ValueError`` / ``RuntimeError`` cases."""
import numpy as np
import pytest
import torch

from repro.launch.mesh import host_mesh_shape as j_host_mesh_shape
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro_torch.launch.mesh import (CPU_POOL_SLOTS, Mesh, device_pool,
                                     dp_axes_of, host_mesh_shape,
                                     make_host_mesh, make_production_mesh)

POOL = ["cpu"] * CPU_POOL_SLOTS


def test_shape_policy_prefers_widest_dividing_model_axis():
    assert host_mesh_shape(8) == (2, 4)
    assert host_mesh_shape(4) == (1, 4)
    assert host_mesh_shape(2) == (1, 2)
    assert host_mesh_shape(12) == (3, 4)


def test_shape_policy_odd_counts_never_drop_devices():
    assert host_mesh_shape(6) == (3, 2)
    assert host_mesh_shape(7) == (7, 1)
    assert host_mesh_shape(3) == (3, 1)
    assert host_mesh_shape(1) == (1, 1)
    for n in range(1, 33):
        d, m = host_mesh_shape(n)
        assert d * m == n
        assert (d, m) == j_host_mesh_shape(n)          # the reference's policy


def test_shape_policy_model_override():
    assert host_mesh_shape(8, model=2) == (4, 2)
    assert host_mesh_shape(8, model=8) == (1, 8)
    assert host_mesh_shape(6, model=3) == (2, 3)
    for n in range(1, 17):
        for model in range(1, n + 1):
            if n % model == 0:
                assert host_mesh_shape(n, model=model) == \
                    j_host_mesh_shape(n, model=model)
    with pytest.raises(ValueError):
        host_mesh_shape(8, model=3)           # must divide
    with pytest.raises(ValueError):
        host_mesh_shape(8, model=0)
    with pytest.raises(ValueError):
        host_mesh_shape(0)


def test_make_host_mesh_builds_submeshes(spmd_devices):
    mesh = make_host_mesh(devices=POOL)       # all slots, policy shape
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.size == spmd_devices == CPU_POOL_SLOTS
    assert mesh.devices.shape == j_make_host_mesh().devices.shape
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    sub = make_host_mesh(2, devices=POOL)     # submesh of the pool
    assert sub.devices.shape == (1, 2) == j_make_host_mesh(2).devices.shape
    pinned = make_host_mesh(8, model=2, devices=POOL)
    assert pinned.devices.shape == (4, 2)
    explicit = make_host_mesh(4, shape=(2, 2), devices=POOL)
    assert explicit.devices.shape == (2, 2)
    with pytest.raises(ValueError):
        make_host_mesh(4, shape=(1, 2), devices=POOL)   # shape must cover n
    with pytest.raises(ValueError):
        make_host_mesh(10 ** 6, devices=POOL)           # more than exist


def test_make_host_mesh_slots_may_repeat_a_device():
    mesh = make_host_mesh(shape=(2, 2), devices=["cuda:0"] * 4)
    assert mesh.devices.shape == (2, 2)
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0"] * 4
    mixed = make_host_mesh(devices=["cpu", torch.device("cpu")])
    assert mixed.devices.shape == (1, 2)
    with pytest.raises(ValueError):
        make_host_mesh(shape=(2, 2), devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        make_host_mesh(devices=POOL, model=3)           # 3 does not divide 8


def test_mesh_defaults_to_the_cards_and_pools_by_device_type():
    assert device_pool(torch.device("cpu")) == [torch.device("cpu")] * 8
    with pytest.raises(ValueError):
        device_pool(torch.device("meta"))
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    assert device_pool(torch.device("cuda")) == []
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()                      # the default pool is the cards
    with pytest.raises(ValueError):
        make_production_mesh()                # (16, 16) needs 256 cards
    with pytest.raises(ValueError):
        make_production_mesh(multi_pod=True)


def test_dp_axes_and_mesh_grid():
    grid = np.array([["cpu"] * 2] * 2, dtype=object)
    assert dp_axes_of(Mesh(grid, ("data", "model"))) == ("data",)
    pods = Mesh(np.array([[["cpu"]]], dtype=object), ("pod", "data", "model"))
    assert dp_axes_of(pods) == ("pod", "data")
    with pytest.raises(ValueError):
        Mesh(grid, ("data",))                 # one name for a 2-d grid
