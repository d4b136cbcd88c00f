"""GPU port, parallelism units without a world of processes: the mesh of a
world of one and JAX's assertion, the tensor-parallel policy leaf by leaf
against JAX's, node sharding under a faked torchrun environment against
JAX's functions, and `shard_batch` of an int8 staging pair."""

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.parallel import distributed as jdistributed
from vocal_remover_tpu.parallel import mesh as jmesh
from vocal_remover_tpu.parallel import policy as jpolicy
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.parallel import distributed, mesh, policy

from torch_port_helpers import TINY

torch.set_num_threads(1)


@pytest.fixture
def world_of_one():
    """A gloo world of this one process, ended after the test."""
    assert distributed.initialize(device="cpu")
    try:
        yield
    finally:
        distributed.shutdown()


def test_make_mesh_on_a_world_of_one(world_of_one):
    m = mesh.make_mesh()
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    assert mesh.axis_rank(m, "data") == 0 and m.device_type == "cpu"
    with pytest.raises(AssertionError) as want:
        jmesh.make_mesh(n_data=2, devices=jax.devices()[:1])
    with pytest.raises(AssertionError) as got:
        mesh.make_mesh(n_data=2)
    assert str(got.value) == str(want.value)
    with pytest.raises(AssertionError, match="requested 1x2 mesh"):
        mesh.make_mesh(n_data=1, n_model=2)


def _leaves(is_complex):
    """(JAX path, port state-dict name, port tensor) of every leaf of the
    tiny net."""
    model = CascadedNet(*TINY, is_complex=is_complex)
    return [(convert._jax_path(k), k, v)
            for k, v in model.state_dict().items()
            if convert._jax_path(k) is not None]


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("is_complex", [False, True])
def test_tp_partition_spec_matches_jax(n_model, is_complex):
    """Every leaf: the port shards dim 0 where JAX shards a conv's output
    channels (HWIO's last axis) or a BN vector, and nothing else; the
    tiny net has leaves that fail each of the two guards."""
    P = jax.sharding.PartitionSpec
    leaves = _leaves(is_complex)
    kinds = set()
    for path, name, t in leaves:
        jleaf = np.zeros(convert._to_jax_layout(t.numpy()).shape, np.float32)
        jpath = [jax.tree_util.DictKey(k) for k in path]
        want = jpolicy.tp_partition_spec(jpath, jleaf, n_model)
        got = policy.tp_partition_spec(name, t, n_model)
        assert (got == 0) == (want != P()), (name, got, want)
        if want != P():
            assert want in (P(None, None, None, "model"), P("model"))
        if path[-1] == "conv" or path[-2] == "bn":
            n = t.shape[0]
            kinds.add("sharded" if got == 0 else
                      "indivisible" if n % n_model else "under 2 rows")
    assert kinds == {"sharded", "indivisible", "under 2 rows"}


@pytest.mark.parametrize("node", [0, 1])
def test_node_sharding_matches_jax_processes(node, monkeypatch):
    """2 nodes x 2 ranks under torchrun: (node, 2) as JAX's (process
    index, process count), and the file shard and seeds JAX's."""
    for k, v in {"RANK": str(2 * node + 1), "WORLD_SIZE": "4",
                 "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
                 "GROUP_RANK": str(node)}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax, "process_index", lambda: node)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    assert distributed.process_info() == jdistributed.process_info() \
        == (node, 2)
    files = [f"song{i}.wav" for i in range(5)]
    assert distributed.shard_filelist(files) == \
        jdistributed.shard_filelist(files)
    assert distributed.host_seed(2019) == jdistributed.host_seed(2019)
    assert distributed.host_shard_kwargs(7) == \
        jdistributed.host_shard_kwargs(7)
    if node == 1:  # one file for two nodes: the second gets none
        with pytest.raises(ValueError) as want:
            jdistributed.shard_filelist(["one.wav"])
        with pytest.raises(ValueError) as got:
            distributed.shard_filelist(["one.wav"])
        assert str(got.value) == str(want.value)


class _DataMesh:
    """A stand-in for a (2, 1) DeviceMesh seen from data rank `rank`."""
    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, rank):
        self.rank = rank

    def size(self, dim):
        return (2, 1)[dim]

    def get_local_rank(self, axis):
        return self.rank if axis == "data" else 0


def test_shard_batch_of_an_int8_pair_matches_jax():
    """{"q": uint8 batch, "scale": 0-d} on two data ranks: each rank's q
    rows are JAX's shard on that device, the scale whole; a batch that
    does not divide raises, as JAX's device_put does."""
    rng = np.random.default_rng(3)
    pair = {"q": rng.integers(0, 256, (4, 2, 5, 6)).astype(np.uint8),
            "scale": np.float32(0.25)}
    jm = jmesh.make_mesh(n_data=2, devices=jax.devices()[:2])
    want = jmesh.shard_batch(jm, pair)
    for r in (0, 1):
        got = mesh.shard_batch(_DataMesh(r), pair)
        shard = next(s for s in want["q"].addressable_shards
                     if s.device == jm.devices[r, 0])
        assert got["q"].dtype == torch.uint8
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(shard.data))
        assert got["scale"].dim() == 0 and float(got["scale"]) == 0.25
    with pytest.raises(ValueError, match="divisible by 2"):
        mesh.shard_batch(_DataMesh(0), pair["q"][:3])
