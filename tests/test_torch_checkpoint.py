"""The port's checkpoints: numpy archives beside the JAX package's JSON
sidecar, and the committed conversion of the model10k forecast head.

`tests/fixtures/model10k_torch` is the orbax checkpoint
`tests/fixtures/model10k/step_60` converted by `convert` below; the test
holds it bit for bit to a fresh orbax restore. Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_checkpoint.py
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

FIXTURES = Path(__file__).resolve().parent / "fixtures"
ORBAX_DIR = FIXTURES / "model10k"
TORCH_DIR = FIXTURES / "model10k_torch"
STEP = 60


def restore_orbax(directory: Path, step: int):
    """(params as {field: numpy array or None}, meta) of a JAX-package
    GraphSAGE checkpoint, restored with the JAX package's own restore."""
    import jax

    from kmamiz_tpu.models import checkpoint as jax_ckpt
    from kmamiz_tpu.models import graphsage as jax_sage

    meta = jax_ckpt.load_metadata(str(directory), step)
    template = jax_sage.init_params(
        jax.random.PRNGKey(0),
        hidden=int(meta["hidden"]),
        num_features=int(meta["num_features"]),
        num_nodes=int(meta.get("num_nodes", 0)),
    )
    optimizer = jax_sage.make_optimizer(float(meta.get("lr", 1e-3)))
    params, _opt, meta = jax_ckpt.restore_checkpoint(
        str(directory), template, optimizer.init(template), step=step
    )
    arrays = {
        k: None if v is None else np.asarray(v) for k, v in params._asdict().items()
    }
    return arrays, meta


def convert(orbax_dir: Path, out_dir: Path, step: int) -> str:
    """Write the port's checkpoint (step_<N>.npz + sidecar) of an orbax
    GraphSAGE checkpoint; returns the archive's path."""
    from kmamiz_tpu_torch.models import checkpoint, graphsage

    arrays, meta = restore_orbax(orbax_dir, step)
    params = checkpoint.params_from_numpy(graphsage, arrays, device="cpu")
    return checkpoint.save_params(str(out_dir), params, step, meta)


def test_committed_npz_equals_the_orbax_restore():
    want, want_meta = restore_orbax(ORBAX_DIR, STEP)
    with np.load(TORCH_DIR / f"step_{STEP}.npz", allow_pickle=False) as archive:
        got = {name: archive[name] for name in archive.files}
    assert set(got) == {k for k, v in want.items() if v is not None}
    for name, arr in got.items():
        assert arr.dtype == want[name].dtype == np.float32, name
        assert arr.shape == want[name].shape, name
        assert arr.tobytes() == want[name].tobytes(), name
    meta = json.loads((TORCH_DIR / f"step_{STEP}.meta.json").read_text())
    assert meta == want_meta == json.loads(
        (ORBAX_DIR / f"step_{STEP}.meta.json").read_text()
    )


def test_conversion_reproduces_the_committed_arrays(tmp_path):
    path = convert(ORBAX_DIR, tmp_path, STEP)
    assert os.path.basename(path) == f"step_{STEP}.npz"
    with np.load(path) as fresh, np.load(TORCH_DIR / f"step_{STEP}.npz") as committed:
        assert sorted(fresh.files) == sorted(committed.files)
        for name in fresh.files:
            assert fresh[name].tobytes() == committed[name].tobytes(), name


def test_committed_fixture_is_small():
    total = sum(p.stat().st_size for p in TORCH_DIR.iterdir())
    assert total < 100_000


def test_restore_params_on_the_cpu():
    from kmamiz_tpu_torch.models import checkpoint, graphsage

    assert checkpoint.latest_complete_step(str(TORCH_DIR)) == STEP
    params, meta = checkpoint.restore_params(str(TORCH_DIR), graphsage, device="cpu")
    assert meta["model"] == "graphsage" and meta["num_features"] == 18
    assert params.embedding is None
    assert params.w_self_1.shape == (18, 64) and params.w_self_1.device.type == "cpu"
    assert all(t.dtype == torch.float32 for t in params if t is not None)


def _tiny_params(seed=0):
    from kmamiz_tpu_torch.models import graphsage

    return graphsage.init_params(
        torch.Generator().manual_seed(seed), hidden=8, num_features=4, device="cpu"
    )


def test_save_restore_round_trip(tmp_path):
    from kmamiz_tpu_torch.models import checkpoint, graphsage

    params = _tiny_params()
    checkpoint.save_params(str(tmp_path), params, 3, {"model": "graphsage", "hidden": 8})
    got, meta = checkpoint.restore_params(str(tmp_path), graphsage, device="cpu")
    assert meta == {"step": 3, "model": "graphsage", "hidden": 8}
    for name, t in params._asdict().items():
        if t is None:
            assert getattr(got, name) is None
        else:
            assert torch.equal(getattr(got, name), t), name
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_incomplete_save_is_skipped(tmp_path):
    from kmamiz_tpu_torch.models import checkpoint, graphsage

    checkpoint.save_params(str(tmp_path), _tiny_params(0), 1, {"model": "graphsage"})
    checkpoint.save_params(str(tmp_path), _tiny_params(1), 2, {"model": "graphsage"})
    os.remove(tmp_path / "step_2.meta.json")  # a crash before the sidecar
    (tmp_path / "step_x.npz").write_bytes(b"")  # stray file: not a step
    assert checkpoint.latest_complete_step(str(tmp_path)) == 1
    assert checkpoint.load_metadata(str(tmp_path))["step"] == 1
    assert checkpoint.load_metadata(str(tmp_path), 2) is None
    _, meta = checkpoint.restore_params(str(tmp_path), graphsage, device="cpu")
    assert meta["step"] == 1
    assert checkpoint.restore_params(str(tmp_path), graphsage, step=5, device="cpu") is None
    assert checkpoint.latest_complete_step(str(tmp_path / "missing")) is None


def test_archives_refuse_pickles(tmp_path):
    from kmamiz_tpu_torch.models import checkpoint, graphsage

    np.savez(tmp_path / "step_1.npz", w_self_1=np.array([{"a": 1}], dtype=object))
    (tmp_path / "step_1.meta.json").write_text('{"step": 1}')
    with pytest.raises(ValueError):
        checkpoint.restore_params(str(tmp_path), graphsage, device="cpu")


def test_params_from_numpy_rejects_unknown_fields():
    from kmamiz_tpu_torch.models import checkpoint, graphsage

    with pytest.raises(ValueError, match="no fields"):
        checkpoint.params_from_numpy(graphsage, {"w_q": np.zeros(1)}, device="cpu")


if __name__ == "__main__":
    sys.path.insert(0, str(FIXTURES.parent.parent))
    print(convert(ORBAX_DIR, TORCH_DIR, STEP))
