"""The port's data pipeline and checkpoints against the reference's on the
CPU: batches bit-identical for tokens, codebooks and the embeddings stub;
checkpoint files byte-identical, bf16 leaves included, and restored in
both directions with exact bits; rotation, async save, atomic commit and
dtype casts as in tests/test_ckpt_data.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as JC
from repro.configs import get_arch
from repro.data import SyntheticLMDataset as RefDataset
from repro.data import make_batch_iterator as ref_batches
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager, latest_step, restore, save
from repro_torch.data import (SyntheticLMDataset, TokenBatcher,
                              make_batch_iterator)
from repro_torch.models import convert
from repro_torch.train import step as TS


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seed", [("internlm2-1.8b", 0),
                                       ("mamba2-130m", 3),
                                       ("musicgen-medium", 1),
                                       ("qwen2-vl-2b", 2)])
def test_batches_bit_identical_to_the_reference(arch, seed):
    """tokens, codebook tokens (musicgen) and the embeddings stub with its
    seed + 17 stream (qwen2-vl): four batches equal to the last bit."""
    ref = ref_batches(get_arch(arch).reduced(), 3, 24, seed=seed)
    port = make_batch_iterator(tconfigs.get_arch(arch).reduced(), 3, 24,
                               seed=seed, device="cpu")
    for _ in range(4):
        a, b = next(port), next(ref)
        assert set(a) == set(b)
        for k in b:
            assert isinstance(a[k], torch.Tensor)
            assert a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])
            assert a[k].numpy().dtype == b[k].dtype


def test_shard_streams_equal_the_reference():
    for shard in (0, 1):
        a = SyntheticLMDataset(vocab_size=1000, seed=3,
                               shard_id=shard).token_stream()
        b = RefDataset(vocab_size=1000, seed=3, shard_id=shard).token_stream()
        assert [next(a) for _ in range(300)] == [next(b) for _ in range(300)]


def test_batcher_shapes_and_label_shift():
    b = next(TokenBatcher(SyntheticLMDataset(vocab_size=500), batch=3,
                          seq_len=16))
    assert b["tokens"].shape == b["labels"].shape == (3, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].max() < 500


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trees():
    """The same tree for both packages: fp32, int32, a 0-d step and a bf16
    leaf, nested dicts with keys out of sorted order."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    h = rng.standard_normal((4, 2)).astype(np.float32)
    j = {"z": jnp.asarray(w), "b": {"c": jnp.arange(6, dtype=jnp.int32)},
         "step": jnp.asarray(7, jnp.int32),
         "ef": jnp.asarray(h, jnp.bfloat16)}
    t = {"z": torch.from_numpy(w), "b": {"c": torch.arange(6,
                                                           dtype=torch.int32)},
         "step": torch.tensor(7, dtype=torch.int32),
         "ef": torch.from_numpy(h).to(torch.bfloat16)}
    return j, t


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def test_checkpoint_files_are_the_reference_bytes(tmp_path):
    j, t = _trees()
    pj = JC.save(str(tmp_path / "ref"), 3, j)
    pt = save(str(tmp_path / "port"), 3, t)
    fj, ft = _files(pj), _files(pt)
    assert list(fj) == list(ft)
    for name in fj:
        assert fj[name] == ft[name], name


def test_port_restores_the_reference_exactly(tmp_path):
    """bf16 leaves included: the reference's ``'<V2'`` files come back
    with the same bits, without ml_dtypes."""
    j, t = _trees()
    JC.save(str(tmp_path), 3, j)
    got = restore(str(tmp_path), like=t, device="cpu")
    assert latest_step(str(tmp_path)) == 3
    for key in ("z", "step", "ef"):
        assert got[key].dtype == t[key].dtype
        assert torch.equal(got[key], t[key]), key
    assert torch.equal(got["b"]["c"], t["b"]["c"])
    assert list(got) == list(t)                    # like's key order
    bits = np.asarray(j["ef"]).view(np.uint16)
    np.testing.assert_array_equal(got["ef"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)


def test_reference_restores_the_port_exactly(tmp_path):
    """Every leaf but bf16 comes back in the reference with the same bits.
    The reference cannot read a bf16 leaf, its own or the port's (its
    ``astype`` has no cast from the ``'<V2'`` array ``np.load`` gives):
    pinned here, and the port reads both."""
    j, t = _trees()
    save(str(tmp_path), 3, t)
    like = {k: v for k, v in j.items() if k != "ef"}
    got = JC.restore(str(tmp_path), like=like)
    for key in ("z", "step"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(j[key]))
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]),
                                  np.asarray(j["b"]["c"]))
    for writer in (save, JC.save):
        d = str(tmp_path / writer.__module__)
        writer(d, 1, t if writer is save else j)
        with pytest.raises(ValueError, match="No cast function"):
            JC.restore(d, like=j)
        assert torch.equal(restore(d, like=t, device="cpu")["ef"], t["ef"])


def test_train_state_round_trips_through_the_reference_layout(tmp_path):
    """A reference train state with bf16 moments and int8 error buffers,
    saved by the reference, restores into the port's layout (blocks a
    list) through convert.stack_blocks / unstack_blocks, exactly; and
    the port's save of it gives the reference's files."""
    cfg = tconfigs.get_arch("hymba-1.5b").reduced()
    jcfg = get_arch("hymba-1.5b").reduced()
    kw = dict(moment_dtype="bfloat16", grad_compression="int8_pod")
    jp, js = JS.init_train_state(jax.random.key(0), jcfg,
                                 JS.TrainConfig(**kw))
    tc = TS.TrainConfig(**kw)
    # nonzero moments and errors so the bits mean something
    js = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(0.5, x.dtype) if x.ndim else x + 5, js)
    JC.save(str(tmp_path / "ref"), 5, {"params": jp, "state": js})
    params = convert.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    like = {"params": params, "state": TS.init_state(cfg, tc, params)}
    got = restore(str(tmp_path / "ref"), 5, like=convert.stack_blocks(like),
                  device="cpu")
    tree = convert.unstack_blocks(got, like)
    assert isinstance(tree["state"]["opt"]["mu"]["blocks"], list)
    assert tree["state"]["ef"]["blocks"][0]["ln1"].dtype == torch.bfloat16
    assert int(tree["state"]["step"]) == 5
    ref_np = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
        else np.asarray(x), {"params": jp, "state": js})
    back = convert.to_reference(tree)
    for path, b in jax.tree_util.tree_leaves_with_path(ref_np):
        a = back
        for k in path:
            a = a[k.key]
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    pt = save(str(tmp_path / "port"), 5, convert.stack_blocks(tree))
    fj, ft = _files(str(tmp_path / "ref" / "step_5")), _files(pt)
    assert fj == ft


def test_atomic_commit_no_partial(tmp_path):
    class Boom:
        shape = (2,)
        dtype = np.float32

        def __array__(self, dtype=None, copy=None):
            raise RuntimeError("disk full")

    with pytest.raises(RuntimeError):
        save(str(tmp_path), 1, {"x": Boom()})
    assert latest_step(str(tmp_path)) is None
    assert not [d for d in os.listdir(tmp_path) if d.startswith("step_")]


def test_manager_rotation_async_and_restore_latest(tmp_path):
    _, t = _trees()
    mgr = CheckpointManager(str(tmp_path / "sync"), keep=2,
                            async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    steps = sorted(int(d.split("_")[1])
                   for d in os.listdir(tmp_path / "sync")
                   if d.startswith("step_"))
    assert steps == [3, 4]
    mgr = CheckpointManager(str(tmp_path / "async"), keep=3)
    src = {"w": torch.ones(4)}
    mgr.save(7, src)
    step, got = mgr.restore_latest({"w": torch.empty(4)}, device="cpu")
    assert step == 7 and torch.equal(got["w"], torch.ones(4))
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(
        src, device="cpu") == (None, None)


def test_restore_casts_to_like_and_names_missing_leaves(tmp_path):
    save(str(tmp_path), 1, {"w": torch.ones(4)})
    got = restore(str(tmp_path), 1, like={"w": torch.empty(
        4, dtype=torch.bfloat16, device="meta")}, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        restore(str(tmp_path), 1, like={"v": torch.empty(4)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"), like={}, device="cpu")


def test_stack_and_unstack_blocks_invert_each_other():
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    ref = jax.tree_util.tree_map(np.asarray,
                                 JT.init_params(jax.random.key(1),
                                                get_arch(
                                                    "mamba2-130m").reduced()))
    params = convert.load_reference_params(ref, cfg, device="cpu")
    back = convert.to_reference(params)
    for path, b in jax.tree_util.tree_leaves_with_path(ref):
        a = back
        for k in path:
            a = a[k.key]
        np.testing.assert_array_equal(a, b)
    again = convert.unstack_blocks(convert.stack_blocks(params), params)
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b)
