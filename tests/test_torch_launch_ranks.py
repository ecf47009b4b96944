"""``repro_torch.launch.train`` under two gloo ranks against one process.

The launcher's ``n_dev > 1`` branch: two CPU ranks joined through a
``file://`` store (``tests/torch_mesh_ranks.py``) train the smoke qwen2 for
3 steps on a (2, 1) ("data", "model") mesh.  In float32 compute
(``launch.train.train``) every step's loss and grad norm is the
single-process run's within 1e-5.  Through the command line
(``launch.train.main --device cpu``, the smoke config's bfloat16 compute,
where each rank's bf16 partial gradients round apart from the whole
batch's) the losses agree within 1e-2, and rank 0 alone prints,
checkpoints and writes ``train_report.json``.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from torch_mesh_ranks import run_ranks, train_cfg  # noqa: E402


@pytest.mark.timeout(300)
def test_two_ranks_match_one_process(tmp_path, capsys):
    cfg = get_config("qwen2-1.5b", smoke=True)
    one = train_launch.train(cfg, steps=3, seq_len=32, device="cpu", ckpt_every=2,
                             log_every=1, ckpt_dir=str(tmp_path / "one"))
    one32 = train_launch.train(train_cfg(), steps=3, seq_len=32, device="cpu", ckpt_every=0,
                               log_every=1, ckpt_dir=str(tmp_path / "one32"))
    capsys.readouterr()
    work = tmp_path / "ranks"
    work.mkdir()
    torch.save({"launch_dir": str(work / "ckpt")}, work / "inputs.pt")
    outs = run_ranks(("launch_f32", "launch"), 2, str(work))
    for case in outs.values():
        assert all("error" not in o for o in case), [o.get("error") for o in case]

    f32 = outs["launch_f32"][0]
    assert outs["launch_f32"][1] == f32  # every rank reports the same numbers
    for key in ("losses", "grad_norms"):
        assert len(f32[key]) == 3
        for a, b in zip(f32[key], one32[key]):
            assert abs(a - b) < 1e-5, (key, f32[key], one32[key])

    out_dir = work / "ckpt" / cfg.name
    report = json.loads((out_dir / "train_report.json").read_text())
    assert report["world"] == 2 and len(report["losses"]) == 3
    for a, b in zip(report["losses"], one["losses"]):
        assert abs(a - b) < 1e-2, (report["losses"], one["losses"])
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "step_00000002", "step_00000003", "train_report.json"]
    lead = (work / "rank2.0.log").read_text()
    other = (work / "rank2.1.log").read_text()
    for line in ("[plan]", "[model]", "step     0", "[done]", "[report]"):
        assert line in lead and line not in other, line
