"""The port's roofline accounting and dry run against the JAX package's:
``count_params`` / ``model_flops`` exactly, ``cost_of``'s counts on
analytic cases, the 1x/2x-pattern extrapolation against a full-depth count,
``report``'s table, ``perf_probe``'s overrides, and one shard of the
billion-vector index searched on the CPU at 2048 rows against the
reference's sharded three-pass search."""

import dataclasses
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_port_helpers import (environ_kept, torch_threads,
                                 worker_thread_share)

from repro.configs import SHAPES as REF_SHAPES, get_config as ref_config
from repro.core.distributed import make_sharded_search3_fn
from repro.launch.mesh import make_test_mesh
from repro.roofline import analysis as ref_analysis
from repro.roofline import report as ref_report
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.launch import dryrun, perf_probe, retrieval_check
from repro_torch.models import Model
from repro_torch.roofline import (H100, analysis, measured_bytes, report,
                                  roofline_from_cost)

with environ_kept():                    # it sets XLA_FLAGS to 512 devices
    from repro.launch import perf_probe as ref_probe

REPO = Path(__file__).resolve().parent.parent
ALL_CONFIGS = list_archs(include_smoke=True)
FAMILY_SMOKES = ["stablelm-1.6b-smoke", "qwen2-moe-a2.7b-smoke",
                 "mamba2-780m-smoke", "recurrentgemma-9b-smoke",
                 "llama-3.2-vision-90b-smoke", "musicgen-medium-smoke"]
TINY = {"train": ShapeConfig("t", 32, 2, "train"),
        "prefill": ShapeConfig("p", 32, 2, "prefill"),
        "decode": ShapeConfig("d", 32, 2, "decode")}


@pytest.fixture(scope="module", autouse=True)
def _thread_share():
    """The file's torch work (the CPU shard's search above all) runs on
    this worker's share of the cores: under ``-n 6`` on 8 cores one
    thread, where torch's default of 8 a worker stalled the search."""
    with torch_threads(worker_thread_share()):
        yield


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_count_params_and_model_flops_equal_reference(name):
    cfg, rcfg = get_config(name), ref_config(name)
    assert analysis.count_params(cfg) == ref_analysis.count_params(rcfg)
    for shape in SHAPES:
        assert analysis.model_flops(cfg, SHAPES[shape]) == \
            ref_analysis.model_flops(rcfg, REF_SHAPES[shape]), shape


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_cost_of_analytic():
    a, b = _meta(64, 128), _meta(128, 32)
    assert analysis.cost_of(torch.mm, a, b) == (
        2 * 64 * 128 * 32, 4 * (64 * 128 + 128 * 32 + 64 * 32))
    x, y = _meta(4, 64, 128, dtype=torch.bfloat16), _meta(4, 128, 32,
                                                          dtype=torch.bfloat16)
    assert analysis.cost_of(torch.bmm, x, y) == (
        2 * 4 * 64 * 128 * 32, 2 * 4 * (64 * 128 + 128 * 32 + 64 * 32))
    # views move nothing; a copy reads and writes its tensor once each
    assert analysis.cost_of(
        lambda t: t.reshape(128, 64).t().transpose(0, 1)[:, :3], a) == (0, 0)
    assert analysis.cost_of(lambda t: t.t().contiguous(), a) == (
        0, 2 * 4 * 64 * 128)
    assert measured_bytes(lambda t: t.t(), a) is None
    assert measured_bytes(torch.mm, a, b) == 4 * (64 * 128 + 128 * 32
                                                  + 64 * 32)


def test_cost_of_in_place_writes():
    """A destination that is only written moves its bytes once; one that
    is read and written (``add_``) twice."""
    a, b = _meta(64, 128), _meta(64, 128)
    n = 4 * 64 * 128
    assert analysis.cost_of(lambda t, u: t.copy_(u), a, b) == (0, 2 * n)
    assert analysis.cost_of(lambda t: t.fill_(1.0), a) == (0, n)
    assert analysis.cost_of(lambda t: t.zero_(), a) == (0, n)
    assert analysis.cost_of(lambda t, u: t.add_(u), a, b) == (0, 3 * n)
    assert analysis.cost_of(lambda t, u: torch.add(t, u, out=t), a, b) == (
        0, 3 * n)


def test_cost_of_meta_equals_cpu():
    """The count on meta tensors is the count of the same call on real
    ones: a step takes the same ops either way."""
    cfg = get_config("qwen2-moe-a2.7b-smoke")
    meta = dryrun.build_cell(cfg, TINY["train"])
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    from repro_torch.optim import adamw_init
    cpu = dataclasses.replace(meta, args=(params, adamw_init(
        params, dryrun.OPT_CFG), batch))
    assert analysis.cost_of(cpu.fn, *cpu.args) == \
        analysis.cost_of(meta.fn, *meta.args)


@pytest.mark.parametrize("name", FAMILY_SMOKES)
def test_extrapolation_equals_full_depth(name):
    """The 1x/2x-pattern counts extrapolated to a full depth that is a
    multiple of the pattern equal the count at that depth, in every cell
    kind: the port's layers repeat exactly."""
    cfg = get_config(name)
    plen = len(Model(cfg).pattern)
    depth = max(3 * plen, -(-cfg.num_layers // plen) * plen)
    cfg = dataclasses.replace(cfg, num_layers=depth)
    for kind, shape in TINY.items():
        cell = dryrun.build_cell(cfg, shape)
        assert dryrun.probe_costs(cfg, shape) == analysis.cost_of(
            cell.fn, *cell.args), kind


def _rows():
    terms = roofline_from_cost(
        3.2e18, 7.5e15, arch="qwen2-7b", shape="train_4k",
        mesh_name="16x16", chips=256, model_flops_val=2.9e18,
        bytes_per_device=5.5e9)
    ok = {**terms.row(), "status": "ok", "fits_hbm": True,
          "microbatches": 1}
    small = {**ok, "shape": "decode_32k", "compute_s": 0.0021,
             "memory_s": 12.5, "dominant": "memory"}
    return [ok, small,
            {"arch": "qwen2-7b", "shape": "long_500k", "mesh": "16x16",
             "status": "skip", "reason": "skipped"},
            {"arch": "deepseek-67b", "shape": "train_4k", "mesh": "16x16",
             "status": "fail", "error": "RuntimeError('meta cannot count')"}]


def test_roofline_terms_and_report_equal_reference(tmp_path):
    rows = _rows()
    assert rows[0]["collective_s"] is None
    assert rows[0]["dominant"] == "compute"
    assert rows[0]["compute_s"] == 3.2e18 / 256 / H100["peak_flops"]
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    outs = []
    for mod in (report, ref_report):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.main(str(path))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "| - |" in outs[0] and len(outs[0].splitlines()) == 6
    assert report.load(str(path)) == rows


def test_parse_overrides_and_probe():
    pairs = ["attn_chunk=1024", "capacity_factor=1.5", "remat=false",
             "act=gelu", "unroll=true"]
    assert perf_probe.parse_overrides(pairs) == \
        ref_probe.parse_overrides(pairs)
    t = perf_probe.probe("stablelm-1.6b-smoke", "train_4k",
                         {"attn_chunk": 256}, verbose=False)
    assert t["collective_s"] is None and t["dominant"] in ("compute",
                                                           "memory")
    assert t["model_flops"] == ref_analysis.model_flops(
        ref_config("stablelm-1.6b-smoke"), REF_SHAPES["train_4k"])


def test_lower_cell_rows(monkeypatch):
    """A prefill cell's row (the memory proof's integer fields, their
    total, the fit on it), a skipped cell's (the reference's reason) and
    the fit search's last resort: where nothing fits HBM_FIT, the
    microbatches' cap (global_batch // data shards) with bf16 moments."""
    row = dryrun.lower_cell("stablelm-1.6b-smoke", "prefill_32k",
                            multi_pod=False, verbose=False)
    mem = [row[k] for k in ("mem_temp", "mem_argument", "mem_output",
                            "mem_alias")]
    assert row["status"] == "ok" and all(
        isinstance(v, int) and v >= 0 for v in mem)
    assert row["bytes_per_device"] == mem[0] + mem[1] + mem[2] - mem[3]
    assert row["mem_temp"] > 0 and row["mem_alias"] == 0
    assert row["mem_temp_model"] == dryrun.MEM_TEMP_MODEL
    assert row["collective"].startswith("not reckoned")
    assert row["fits_hbm"] and row["useful_ratio"] > 0
    f32 = dryrun.lower_cell("stablelm-1.6b-smoke", "train_4k",
                            multi_pod=False, verbose=False, probes=False)
    monkeypatch.setattr(dryrun, "HBM_FIT", 1)
    bf16 = dryrun.lower_cell("stablelm-1.6b-smoke", "train_4k",
                             multi_pod=False, verbose=False, probes=False)
    assert (f32["opt_moments"], bf16["opt_moments"]) == ("float32",
                                                         "bfloat16")
    assert (f32["microbatches"], bf16["microbatches"]) == (1, 256 // 16)
    assert f32["mem_alias"] == f32["mem_output"] - 6 * 4   # 6 0-d metrics
    assert bf16["mem_argument"] < f32["mem_argument"]
    assert bf16["mem_temp"] < f32["mem_temp"]
    skip = dryrun.lower_cell("qwen2-7b", "long_500k", multi_pod=True,
                             verbose=False)
    assert skip == {"arch": "qwen2-7b", "shape": "long_500k",
                    "mesh": "2x16x16", "status": "skip",
                    "reason": dryrun.skip_reason(get_config("qwen2-7b"),
                                                 SHAPES["long_500k"])}
    assert "sub-quadratic" in skip["reason"]
    assert dryrun.skip_reason(get_config("mamba2-780m"),
                              SHAPES["long_500k"]) is None


def test_dryrun_main_writes_rows(tmp_path):
    out = tmp_path / "rows.jsonl"
    dryrun.main(["--arch", "mamba2-780m-smoke", "--shape", "decode_32k",
                 "--no-probes", "--out", str(out)])
    row = json.loads(out.read_text())
    assert row["status"] == "ok" and row["mem_argument"] > 0
    r = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report",
                        str(out)], capture_output=True, text=True,
                       timeout=120, cwd=REPO,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0 and "mamba2-780m-smoke" in r.stdout, r.stderr


def _check_only(arrs, backend, row_offset, blocks, results, dev, runs):
    return {"check": retrieval_check.check_form(arrs, backend, row_offset,
                                                blocks, results, dev)}


@pytest.fixture(scope="module")
def retrieval_blocks():
    """The CPU shard (2^15 points: 2048 rows a shard) in one query block,
    with the smoke's checks and kernel times, and in four, with the checks
    alone; with their results."""
    return {b: dryrun.lower_retrieval(
        multi_pod=False, num_points=2 ** 15, device="cpu", query_blocks=b,
        runs=1, keep_results=True, inspect=inspect, verbose=False)
        for b, inspect in ((1, retrieval_check.inspect_form),
                           (4, _check_only))}


def test_retrieval_checks_and_blocks(retrieval_blocks):
    one, four = retrieval_blocks[1], retrieval_blocks[4]
    assert one["rows"] == 2048 and one["row_offset"] == 15 * 2048
    assert four["query_blocks"]["blocks"] == 4
    for row in (one, four):
        for form in ("cuda", "cuda-packed"):
            f = row["forms"][form]
            c = f["check"]
            assert f["ids_in_shard"] and all(c[k] for k in (
                "block_tail_equals_plain", "tail_equals_plain",
                "k1_equals_plain", "three_pass_equals_plain_route")), (
                form, c)
            assert c["fused_equals_plain"] == {
                str(dryrun.H): True, str(dryrun.ALPHA * dryrun.H): True}, (
                form, c)
            assert c["blocked_rows_equal_alone"] == {
                "pass1": True, "three_pass": True}, (form, c)
            for call in ("pass1", "three_pass"):
                for j in (0, 1):
                    assert torch.equal(
                        f["results"][call][j],
                        one["forms"][form]["results"][call][j]), (form, call)
    packed = one["forms"]["cuda-packed"]["results"]["three_pass"]
    assert torch.equal(packed[1], one["forms"]["cuda"]["results"][
        "three_pass"][1])
    kt = one["forms"]["cuda"]["kernels"]
    assert [kt[w]["queries"] for w in ("block", "half_block",
                                       "check_queries")] == [128, 64, 4]
    assert {"plain_tail_ms", "k1_sort_ms", "k2_ms", "b4_ms"} <= set(
        kt["check_queries"])
    assert "kernels" not in four["forms"]["cuda"]


@pytest.mark.parametrize("packed", [False, True])
def test_plain_scan_slices_equal_whole(packed):
    """The check's plain scan, a slice of rows at a time (here slices that
    do not divide the rows), gives the one-call plain version's bits."""
    from repro_torch.kernels.lut16 import pack_codes
    from repro_torch.kernels.ref import lut16_adc_plain

    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 16, (1000, 10), np.uint8))
    if packed:
        codes = torch.as_tensor(np.asarray(pack_codes(codes.numpy())))
    lut = torch.from_numpy(rng.standard_normal((3, 10, 16), np.float32))
    got = retrieval_check.plain_scan(codes, lut, packed=packed,
                                     slice_rows=300)
    assert torch.equal(got, lut16_adc_plain(codes, lut, packed=packed))


def test_retrieval_shard_equals_reference(retrieval_blocks):
    """The shard's three-pass ids equal the reference's
    ``make_sharded_search3_fn`` on a one-device mesh over the same arrays
    (its row offset given), scores within rtol 1e-5 / atol 1e-4."""
    row = retrieval_blocks[1]
    n = row["rows"]
    arrs = {k: v.numpy() for k, v in dryrun.retrieval_shard(
        n, seed=row["seed"], device="cpu").items()}
    fn = make_sharded_search3_fn(make_test_mesh((1,), ("data",)),
                                 h=dryrun.H, alpha=dryrun.ALPHA,
                                 beta=dryrun.BETA)
    s, ids = fn(arrs["codes"], arrs["lut"], arrs["inv_rows"],
                arrs["inv_vals"], arrs["res_q"], arrs["res_scale"],
                arrs["res_zero"], arrs["sres_cols"], arrs["sres_vals"],
                arrs["q_dims"], arrs["q_vals"], arrs["q_dense"],
                arrs["q_cols"], np.array([row["row_offset"]], np.int32))
    got_s, got_ids = row["forms"]["cuda"]["results"]["three_pass"]
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(s), rtol=1e-5,
                               atol=1e-4)
    jax.clear_caches()
