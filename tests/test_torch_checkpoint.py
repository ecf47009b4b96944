"""The port's ``CheckpointManager`` against the reference's (``repro.checkpoint``).

Ports of the four checkpoint tests of ``tests/test_substrates.py``, each
also held to the reference: the same on-disk layout (``step_%08d/`` published
by an atomic rename of ``tmp_%08d/``, ``leaf_%05d.npy`` files, a
``manifest.json`` of ``step`` and per-leaf ``key`` / ``file`` / ``shape`` /
``dtype`` / ``crc32``), keep-K pruning, the fallback past a corrupted leaf
to the newest valid step, and ``save_async``.  Keys are each package's own
tree paths; the leaves' bytes, shapes, dtypes and CRCs are equal.  Beside
them: a ``TrainState`` round trip (master weights come back trainable on
their device) and the refusal of a bfloat16 leaf.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.train import init_state  # noqa: E402


def _tiny_state():
    return {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
        "step": torch.tensor(4, dtype=torch.int32),
    }


def _jax_tiny_state():
    return {
        "params": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)},
        "step": jnp.asarray(4, jnp.int32),
    }


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path / "port", keep=2)
    state = _tiny_state()
    mgr.save(4, state)
    restored, step = mgr.restore(_tiny_state())
    assert step == 4
    torch.testing.assert_close(restored["params"]["w"], state["params"]["w"], rtol=0, atol=0)
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 4
    # the reference's layout and leaves, leaf for leaf
    JaxCheckpointManager(tmp_path / "ref", keep=2).save(4, _jax_tiny_state())
    got = _manifest(tmp_path / "port" / "step_00000004")
    want = _manifest(tmp_path / "ref" / "step_00000004")
    assert got["step"] == want["step"] == 4
    assert [leaf["key"] for leaf in got["leaves"]] == ["params.w", "step"]
    for g, w in zip(got["leaves"], want["leaves"]):
        assert {k: g[k] for k in ("file", "shape", "dtype", "crc32")} == \
            {k: w[k] for k in ("file", "shape", "dtype", "crc32")}
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "step_00000004" / g["file"]),
                                      np.load(tmp_path / "ref" / "step_00000004" / w["file"]))
    assert not list((tmp_path / "port").glob("tmp_*"))  # the tmp dir was renamed


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path / "port", keep=2)
    ref = JaxCheckpointManager(tmp_path / "ref", keep=2)
    for s in (1, 2, 3):
        mgr.save(s, _tiny_state())
        ref.save(s, _jax_tiny_state())
    assert mgr.all_steps() == [2, 3] == ref.all_steps()
    assert mgr.latest_step() == 3 == ref.latest_step()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_checkpoint_corruption_fallback(tmp_path):
    for name, mgr, state in (("port", CheckpointManager, _tiny_state()),
                             ("ref", JaxCheckpointManager, _jax_tiny_state())):
        m = mgr(tmp_path / name, keep=3)
        m.save(1, state)
        m.save(2, state)
        # corrupt step 2's first leaf
        leaf = next((tmp_path / name / "step_00000002").glob("leaf_*.npy"))
        np.save(leaf, np.load(leaf) + 1)
        like = state if name == "port" else jax.eval_shape(lambda: state)
        _, step = m.restore(like)
        assert step == 1, name  # CRC check rejected step 2


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _tiny_state()
    mgr.save_async(7, state)
    state["params"]["w"].add_(1.0)  # the host copy was taken before save_async returned
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _ = mgr.restore(_tiny_state())
    torch.testing.assert_close(restored["params"]["w"], _tiny_state()["params"]["w"])


def test_train_state_roundtrip_and_bf16_refusal(tmp_path):
    cfg = get_config("qwen2-1.5b", smoke=True)
    model, opt = build_model(cfg), AdamW(1e-3)
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(0, state)
    keys = [leaf["key"] for leaf in _manifest(tmp_path / "step_00000000")["leaves"]]
    assert keys[:2] == ["step", "params.embed"] and "opt_state.m.layers.1.attn.wq" in keys
    like = init_state(model, opt, torch.Generator().manual_seed(1))
    restored, step = mgr.restore(like)
    assert step == 0
    for path, leaf in restored.params.leaves().items():
        torch.testing.assert_close(leaf, state.params.leaves()[path], rtol=0, atol=0)
        assert leaf.requires_grad and isinstance(leaf, torch.nn.Parameter), path
    assert restored.opt_state.m.keys() == state.opt_state.m.keys()
    bf16 = {"w": torch.ones(3, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.save(1, bf16)
    assert mgr.all_steps() == [0]
