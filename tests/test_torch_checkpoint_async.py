"""The port's checkpoint writer (`ngf_tpu_torch/utils/checkpoint.py`), held
to `tests/test_checkpoint_async.py`: a background write gives the file a
synchronous one gives, a crash mid-write keeps the old file and leaves no
``.tmp``, a failed write is loud at the next wait and the writer stays
usable, ``submit`` returns while the write is in flight, and the snapshot is
taken at ``pack_checkpoint`` (in-place updates after it do not reach the
file). The trainer's periodic saves go through it and log
``ckpt/blocked_s``; `ngf_tpu` reads what it writes."""

import json
import os
import sys
import threading

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from ngf_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from ngf_tpu_torch.config import TrainArgs  # noqa: E402
from ngf_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer  # noqa: E402
from ngf_tpu_torch.utils.checkpoint import (  # noqa: E402
    AsyncCheckpointWriter,
    load_checkpoint,
    load_extra_arrays,
    pack_checkpoint,
    save_checkpoint,
    write_arrays_atomic,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"plane": torch.randn(4, 8, generator=g),
            "mlp": {"w": torch.randn(8, 3, generator=g)}}


def _same_files(a: str, b: str) -> None:
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_async_equals_sync(tmp_path):
    params, vol = _params(0), (torch.rand(4, 4, 4, generator=torch.Generator().manual_seed(1)) > 0.5)
    kw = dict(alpha_volume=vol.float(), alpha_aabb=torch.zeros(2, 3),
              extra_arrays={"ray_ids": np.arange(5), "m": torch.ones(3)})
    sync_p, async_p = str(tmp_path / "sync.npz"), str(tmp_path / "async.npz")
    save_checkpoint(sync_p, params, {"it": 7}, **kw)
    w = AsyncCheckpointWriter()
    w.submit(async_p, pack_checkpoint(params, {"it": 7}, **kw))
    w.wait()
    _same_files(async_p, sync_p)
    got, meta, gvol, _ = load_checkpoint(async_p, "cpu")
    assert meta["it"] == 7 and torch.equal(gvol, vol.float())
    assert torch.equal(got["mlp"]["w"], params["mlp"]["w"])
    np.testing.assert_array_equal(load_extra_arrays(async_p)["ray_ids"], np.arange(5))
    # The JAX package reads the same file.
    jparams, jmeta, jvol, _ = j_ckpt.load_checkpoint(async_p)
    np.testing.assert_array_equal(jparams["plane"], params["plane"].numpy())
    np.testing.assert_array_equal(jvol, vol.float().numpy())


def test_snapshot_is_taken_at_pack(tmp_path):
    """CPU tensors: the packed arrays are copies, so a step that updates the
    parameters in place while the write is in flight does not reach it."""
    params = _params(2)
    want = params["plane"].clone()
    arrays = pack_checkpoint(params, extra_arrays={"m": params["mlp"]["w"]})
    params["plane"].add_(1.0)
    params["mlp"]["w"].zero_()
    path = str(tmp_path / "m.npz")
    write_arrays_atomic(path, arrays)
    got, _, _, _ = load_checkpoint(path, "cpu")
    assert torch.equal(got["plane"], want)
    assert np.abs(load_extra_arrays(path)["m"]).sum() > 0


def test_crash_mid_write_preserves_old_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "model.npz")
    old = _params(1)
    save_checkpoint(path, old, {"it": 1})

    def _dying_savez(f, **arrays):
        f.write(b"PK\x03\x04 truncated npz bytes")
        raise RuntimeError("simulated crash mid-write")

    monkeypatch.setattr(np, "savez", _dying_savez)
    with pytest.raises(RuntimeError, match="simulated crash"):
        write_arrays_atomic(path, {"x": np.zeros(3)})
    monkeypatch.undo()
    got, meta, _, _ = load_checkpoint(path, "cpu")
    assert meta["it"] == 1 and torch.equal(got["plane"], old["plane"])
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_writer_failure_is_loud_on_next_wait(tmp_path):
    w = AsyncCheckpointWriter()
    w.submit(str(tmp_path / "no_such_dir" / "m.npz"), {"x": np.zeros(2)})
    with pytest.raises(FileNotFoundError):
        w.wait()
    ok = str(tmp_path / "ok.npz")
    w.submit(ok, {"x": np.arange(3)})  # reusable after a failure
    w.wait()
    assert np.array_equal(np.load(ok)["x"], np.arange(3))
    # A failure also surfaces at the next submit, which then writes nothing.
    w.submit(str(tmp_path / "no_such_dir" / "m.npz"), {"x": np.zeros(2)})
    with pytest.raises(FileNotFoundError):
        w.submit(str(tmp_path / "next.npz"), {"x": np.zeros(2)})
    assert not os.path.exists(tmp_path / "next.npz")


def test_submit_does_not_block_on_serialization(tmp_path, monkeypatch):
    gate = threading.Event()
    real_savez = np.savez

    def _gated_savez(f, **arrays):
        gate.wait(timeout=30)
        real_savez(f, **arrays)

    monkeypatch.setattr(np, "savez", _gated_savez)
    path = str(tmp_path / "gated.npz")
    w = AsyncCheckpointWriter()
    w.submit(path, {"x": np.arange(4)})
    assert not os.path.exists(path)  # the write waits behind the gate
    gate.set()
    w.wait()
    assert np.array_equal(np.load(path)["x"], np.arange(4))


def test_trainer_periodic_saves_in_background(tmp_path):
    """A run with ``save_every`` logs ``ckpt/blocked_s`` at its periodic
    saves and ends with a synchronous, resume-complete checkpoint that
    `ngf_tpu` loads."""
    args = TrainArgs(subsystem="infoinv", dataset_name="synthetic", batch_size=128, n_iters=16,
                     nSamples=32, vis_every=0, N_vis=0, save_every=8, upsamp_list=[],
                     update_AlphaMask_list=[], seed=0, plane_res=16, gauge_res=16,
                     alpha_grid_res=16, device="cpu")
    train = make_synthetic_dataset("train", n_views=4, wh=(24, 24))
    out = str(tmp_path / "run")
    TriPlaneTrainer(args, train, None, out, device="cpu").run()
    rows = [json.loads(line) for line in open(os.path.join(out, "scalars.jsonl"))]
    blocked = [r for r in rows if "ckpt/blocked_s" in r]
    assert [r["step"] for r in blocked] == [8]  # 16 is the final synchronous save
    assert all(r["ckpt/blocked_s"] >= 0 for r in blocked)
    _, meta, _, _ = j_ckpt.load_checkpoint(os.path.join(out, "model.npz"))
    assert meta["iteration"] == 16 and set(meta["resume"]) >= {
        "l1_weight", "auto_cap", "rgb_stat", "auto_rgb_cap", "n_voxel_list", "sampler_birth"}
    extra = j_ckpt.load_extra_arrays(os.path.join(out, "model.npz"))
    assert {"key", "ray_ids", "torch_generator", "opt/0000"} <= set(extra)
    assert extra["key"].dtype == np.uint32 and extra["key"].shape == (2,)
