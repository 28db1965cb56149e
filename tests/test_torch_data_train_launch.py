"""The port's synthetic LM data (``repro_torch.data.pipeline``), its pass-1
byte model (``repro_torch.roofline``) and its training launcher
(``python -m repro_torch.launch.train``).

``synthetic_batch`` draws the reference's bits: its threefry2x32 key
operations and samplers are re-derived in numpy, held here bit for bit to
``jax.random`` on a grid of (seed, step, B, S, V), in the partitionable
mode of the installed jax (pinned from ``jax.config``).  The byte model is
held equal to the reference's on a grid of shapes.  The launcher runs at
smoke size on the CPU in a process where jax cannot be imported."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synthetic_batch as ref_batch
from repro.roofline.pass1 import predicted_pass1_bytes as ref_bytes
from repro_torch.data import pipeline as P
from repro_torch.roofline import predicted_pass1_bytes

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _partitionable():
    """The draws follow jax's partitionable threefry, the default of the
    installed jax: pin it, so the grid holds what the reference draws."""
    assert jax.config.jax_threefry_partitionable


# ---------------------------------------------------------------------------
# the key operations and samplers
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 1234, 2 ** 31 - 1, -7]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_ops_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(P.prng_key(seed), np.asarray(key))
    for data in (0, 1, 77, 2 ** 31 - 1):
        f = jax.random.fold_in(key, data)
        np.testing.assert_array_equal(P.fold_in(P.prng_key(seed), data),
                                      np.asarray(f))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(P.split(np.asarray(f), num),
                                      np.asarray(jax.random.split(f, num)))
    np.testing.assert_array_equal(P.random_bits(np.asarray(f), (3, 7)),
                                  np.asarray(jax.random.bits(f, (3, 7))))


@pytest.mark.parametrize("span", [(0, 1), (1, 7), (0, 997), (0, 65536),
                                  (0, 65537), (0, 100352), (0, 256000),
                                  (-5, 2 ** 31 - 1), (3, 3)])
def test_randint_matches_jax(span):
    """Spans on both sides of 2**16, where the reference's uint32 multiplier
    wraps to 0, and an empty span."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    lo, hi = span
    np.testing.assert_array_equal(
        P.randint(np.asarray(key), (4, 33), lo, hi),
        np.asarray(jax.random.randint(key, (4, 33), lo, hi)))


@pytest.mark.parametrize("p", [0.05, 0.5, 1e-3])
def test_uniform_and_bernoulli_match_jax(p):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    np.testing.assert_array_equal(P.uniform(np.asarray(key), (5, 19)),
                                  np.asarray(jax.random.uniform(key,
                                                                (5, 19))))
    np.testing.assert_array_equal(
        P.bernoulli(np.asarray(key), p, (5, 190)),
        np.asarray(jax.random.bernoulli(key, p, (5, 190))))


GRID = [(1234, 0, 4, 16, 128), (1234, 7, 8, 32, 997), (0, 0, 8, 512, 100352),
        (0, 3, 2, 33, 152064), (5, 123456, 3, 17, 256000),
        (2 ** 31 - 1, 2 ** 31 - 1, 1, 2, 64), (9, 1, 16, 64, 512),
        (1, 2, 8, 128, 32000)]


@pytest.mark.parametrize("seed,step,b,s,v", GRID)
def test_synthetic_batch_bit_for_bit(seed, step, b, s, v):
    cfg = P.DataConfig(vocab_size=v, seq_len=s, global_batch=b, seed=seed)
    want = ref_batch(RefDataConfig(vocab_size=v, seq_len=s, global_batch=b,
                                   seed=seed), step)
    got = P.synthetic_batch(cfg, step, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and got[k].shape == (b, s)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                  got["labels"][:, :-1].numpy())


def test_synthetic_batch_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.synthetic_batch(P.DataConfig(64, 8, 2), 0)


# ---------------------------------------------------------------------------
# the pass-1 byte model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [1, 8, 128])
@pytest.mark.parametrize("n,k", [(524288, 100), (152064, 1792), (1000, 7)])
def test_predicted_pass1_bytes_match_reference(q, n, k):
    for packed in (False, True):
        kc = -(-k // 2) if packed else k
        for fused in (False, True):
            for cbuf in (None, 128, 512):
                kw = dict(q=q, n=n, k_codes=kc, packed=packed, fused=fused,
                          cbuf=cbuf)
                got = predicted_pass1_bytes(**kw)
                assert isinstance(got, int)
                assert got == ref_bytes(**kw), kw
    assert predicted_pass1_bytes(q=q, n=n, k_codes=k, l=32) == ref_bytes(
        q=q, n=n, k_codes=k, l=32)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_NO_JAX = ("import sys\n"
           "sys.modules['jax'] = None\n"
           "sys.modules['repro'] = None\n"
           "sys.modules['ml_dtypes'] = None\n"
           "from repro_torch.launch.train import main\n"
           "main(sys.argv[1:])\n")


def _launch(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-c", _NO_JAX, *args],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=str(REPO))


def test_launch_train_on_cpu(tmp_path):
    """4 steps of stablelm-1.6b-smoke on the CPU with a checkpoint every 2,
    in a process where jax, the JAX package and ml_dtypes cannot be
    imported; a second run resumes at 4 and goes to 12 (a log line at step
    10); a third finds nothing left to run."""
    ckpt = str(tmp_path / "ckpt")
    common = ["--arch", "stablelm-1.6b-smoke", "--batch", "4", "--seq",
              "32", "--device", "cpu", "--ckpt", ckpt, "--ckpt-every", "2"]
    r = _launch(*common, "--steps", "4")
    assert r.returncode == 0, r.stderr[-2000:]
    done = [ln for ln in r.stdout.splitlines() if ln.startswith("done: ")]
    assert len(done) == 1 and done[0].startswith("done: loss ") and \
        " -> " in done[0]
    assert sorted(os.listdir(ckpt)) == ["manifest.json", "step_2", "step_4"]
    r = _launch(*common, "--steps", "12", "--ckpt-every", "100")
    assert r.returncode == 0, r.stderr[-2000:]
    assert [ln.split(":")[0] for ln in r.stdout.splitlines()
            if ln.startswith("step ")] == ["step 10"]
    r = _launch(*common, "--steps", "4")
    assert r.returncode == 0 and "done: no step to run" in r.stdout


def test_launch_train_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _launch("--arch", "stablelm-1.6b-smoke", "--steps", "2", "--ckpt",
                str(tmp_path))
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_new_modules_import_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            "import repro_torch.optim, repro_torch.train, "
            "repro_torch.checkpoint.checkpoint, repro_torch.data.pipeline, "
            "repro_torch.roofline, repro_torch.launch.train, "
            "repro_torch.models.layout, repro_torch.interchange\n"
            "assert not {'jax', 'ml_dtypes'} & {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stderr
