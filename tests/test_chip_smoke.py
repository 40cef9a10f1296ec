"""chip_smoke.py off the card: it refuses a CPU-only host, and every phase
runs end to end at tiny widths on the CPU (the card runs them at the
flagship widths).  The ``gpu`` cases run the tiny phases on the card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_main_refuses_cpu_without_a_result(capsys):
    assert cs.main([]) != 0
    assert cs.main(["--four"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_device_and_env(capsys):
    with pytest.raises(RuntimeError, match="no gpu"):
        cs.phase_device("gpu")
    assert cs.phase_device("cpu")["platform"] == "cpu"
    cs.phase_env()
    out = capsys.readouterr().out
    assert "card:" in out and '"jax"' in out and '"PIL"' in out


def test_phase_predict_tiny(tmp_path, capsys):
    out = cs.phase_predict(cs.TINY, str(tmp_path / "trace"))
    assert out["predict_folded"] > 0 and out["DepthUNet.predict"] > 0
    assert out["device_ms"] > 0
    assert "top-k ops" in capsys.readouterr().out


def test_phase_train_tiny(tmp_path):
    out = cs.phase_train(cs.TINY, str(tmp_path))
    assert len(out["losses"]) >= 2 and out["ms_per_step"] > 0


def test_phase_reference_tiny(capsys):
    cs.phase_reference(cs.TINY)
    out = capsys.readouterr().out
    assert "histogram: identical" in out and "grad_field" in out


def test_phase_four_tiny(capsys):
    cs.phase_four(cs.TINY)
    out = capsys.readouterr().out
    assert "120 of 120 leaves within max(0.0001" in out
    assert "0 of them at a rank whose labels" in out
    assert "identical to the sharded labels: True" in out


def test_leaf_errors_are_relative_to_each_leaf():
    want = {"big": np.array([1.0, 2.0]), "small": np.array([1e-6, 0.0])}
    got = {"big": np.array([1.0, 2.0]), "small": np.array([1e-6 + 1e-9, 0])}
    rows = cs.leaf_errors(got, want)
    assert rows[0][2] == "['small']" and abs(rows[0][0] - 1e-3) < 1e-9
    assert rows[1] == (0.0, 2.0, "['big']")


def test_tie_groups_split_at_the_rounding_bound():
    groups, bound = cs.tie_groups(np.array([[1.0, 1.0 - 1e-5, 0.5, 0.5]]),
                                  512)
    assert 1.2e-4 < bound < 1.3e-4
    assert groups.tolist() == [[1, 1, 2, 2]]


@pytest.mark.parametrize("got, bad", [
    ([[10, 11, 12]], False),  # identical
    ([[11, 10, 12]], False),  # ranks 0 and 1 are a near-tie: a legal swap
    ([[10, 11, 13]], False),  # last rank swapped with the 4th, a near-tie
    ([[12, 11, 10]], True),   # ranks 0 and 2 are not in one tie group
    ([[10, 12, 11]], True),   # ranks 1 and 2 hold a clear gap
])
def test_excused_flips_only_within_a_rank_s_own_tie_group(got, bad):
    want = np.array([[10, 11, 12]])
    ref_ids = np.array([[10, 11, 12, 13]])
    groups, _ = cs.tie_groups(np.array([[0.9, 0.9 - 1e-6, 0.5, 0.5 - 1e-6]]),
                              512)
    assert cs.excused_flips(np.array(got), want, ref_ids, groups)[0] == bad


def test_close_is_relative_to_the_reference_scale():
    assert "max |diff|" in cs._close("x", [1.0, 2e-5], [1.0, 0.0], 1e-4)
    with pytest.raises(AssertionError, match="max"):
        cs._close("x", [1.0, 3e-4], [1.0, 0.0], 1e-4)
    with pytest.raises(AssertionError, match="shape"):
        cs._close("x", [1.0], [1.0, 0.0], 1e-4)
    json.dumps(cs.FLAGSHIP.__dict__)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["predict", "train", "reference"])
def test_phase_tiny_on_the_card(gpu_env, phase, tmp_path):
    call = {
        "predict": f"cs.phase_predict(cs.TINY, {str(tmp_path / 'trace')!r})",
        "train": f"cs.phase_train(cs.TINY, {str(tmp_path)!r})",
        "reference": "cs.phase_reference(cs.TINY)",
    }[phase]
    code = ("import chip_smoke as cs; cs.phase_device('gpu'); "
            + call + "; print('PHASE OK')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=gpu_env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "PHASE OK" in proc.stdout
