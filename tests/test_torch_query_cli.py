"""The port's CLI on the CPU: usage errors exit 2; SMAFA_TPU_TORCH_DEVICE
picks the device and never falls back from cuda to the CPU; a CPU query
launches no kernel; SMAFA_TPU_TRACE_DIR writes a torch.profiler trace,
and unset starts no profiler; the runner equals smafa_tpu's; key
overflow names ROADMAP.md; importing the port (cluster included) loads
neither jax nor triton."""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from smafa_tpu_torch.cli import main as main1
from test_torch_query import D, _cpu, run  # noqa: F401


@pytest.mark.parametrize("argv", [
    ["query", "-d", "x", "-q", "y", "--max-divergence", "-1"],
    ["query", "-d", "x", "-q", "y", "--max-num-hits", "-3"],
    ["query", "-d", "x", "-q", "y", "--limit-per-sequence", "zz"],
    ["query", "-d", "x"],
    ["makedb", "-i", "x"],
    ["count"],
])
def test_usage_errors_exit_2(capsys, argv):
    with pytest.raises(SystemExit) as ei:
        main1(argv)
    assert ei.value.code == 2


@pytest.mark.parametrize("value,ok", [("cpu", True), ("CUDA", False),
                                      ("tpu", False), (None, False)])
def test_device_env(capsys, monkeypatch, value, ok):
    """SMAFA_TPU_TORCH_DEVICE forces the device; cuda without a card and
    unknown values are errors. Unset, the device is cuda: with no card
    visible the run fails and names the variable, never falling back to
    the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if value is None:
        monkeypatch.delenv("SMAFA_TPU_TORCH_DEVICE")
    else:
        monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", value)
    code, out, err = run(capsys, main1, "query", "-d",
                         f"{D}/random_3_2.fna.smafadb", "-q",
                         f"{D}/random_3_2.fna")
    if ok:
        assert code == 0 and "Using device cpu" in err
    else:
        assert code == 101 and "SMAFA_TPU_TORCH_DEVICE" in err


def test_cpu_query_launches_no_kernel(capsys):
    from smafa_tpu_torch.ops import compact, min2

    min2.launches = compact.launches = 0
    code, _, _ = run(capsys, main1, "query", "-d",
                     f"{D}/random_3_2_one_repeated.fna.smafadb", "-q",
                     f"{D}/random_3_2.fna")
    assert code == 0
    assert min2.launches == 0 and compact.launches == 0


@pytest.mark.parametrize("traced", [True, False])
def test_trace_dir(capsys, tmp_path, monkeypatch, traced):
    """With SMAFA_TPU_TRACE_DIR, query runs under torch.profiler (CPU
    activity here) and writes its Chrome trace there; without it the
    profiler never starts. The output is the same."""
    import json

    from torch import profiler

    started = []
    real = profiler.profile
    monkeypatch.setattr(profiler, "profile",
                        lambda *a, **kw: started.append(kw) or real(*a, **kw))
    trace = tmp_path / "trace"
    if traced:
        monkeypatch.setenv("SMAFA_TPU_TRACE_DIR", str(trace))
    else:
        monkeypatch.delenv("SMAFA_TPU_TRACE_DIR", raising=False)
    code, out, _ = run(capsys, main1, "query", "-d",
                       f"{D}/random_3_2.fna.smafadb", "-q",
                       f"{D}/random_3_2.fna")
    assert code == 0 and out == "0\t0\t0\tCTT\n1\t1\t0\tAGG\n"
    if not traced:
        assert started == [] and not trace.exists()
        return
    assert [kw["activities"] for kw in started] == [
        [profiler.ProfilerActivity.CPU]]
    (path,) = trace.iterdir()
    assert path.name.endswith(".pt.trace.json") and "rank" not in path.name
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.mark.parametrize("names,lost", [
    (["(anonymous namespace)::min2_split_kernel(signed char const*)",
      "(anonymous namespace)::min2_merge_kernel(int const*)",
      "(anonymous namespace)::compact_split_kernel(signed char const*)"],
     {"min2": (2, 3)}),
    ([], {"min2": (0, 3), "compact": (0, 1), "any kernel": (0, 1)}),
    (["(anonymous namespace)::min2_long_kernel<true>(signed char const*)"] * 3
     + ["(anonymous namespace)::compact_long_kernel(signed char const*)",
        "void at::native::vectorized_elementwise_kernel<4>()"], {})])
def test_lost_kernel_events(names, lost):
    """maybe_trace's check on a card: the port's kernels whose device
    events in the profile are fewer than their wrappers' launches, and a
    profile without any device event; host events do not count."""
    import types

    from torch.autograd import DeviceType

    from smafa_tpu_torch.utils.profiling import lost_kernel_events

    def event(name, dev):
        return types.SimpleNamespace(name=lambda: name,
                                     device_type=lambda: dev)

    events = ([event(x, DeviceType.CUDA) for x in names]
              + [event("aten::min2_split_kernel", DeviceType.CPU)])
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert lost_kernel_events(prof, {"min2": 3, "compact": 1, "kstats": 0,
                                     "min_count": 0}) == lost


def test_runner_from_codes_matches_scan_runner():
    """The runner built from the very codes smafa_tpu's ScanRunner takes
    gives the same best-hit result."""
    import torch

    from smafa_tpu.parallel.sharded import ScanRunner, build_mesh
    from smafa_tpu_torch.parallel.runner import ScanRunner as TorchRunner

    rng = np.random.default_rng(4)
    base = rng.integers(0, 4, (100, 60)).astype(np.uint8)
    codes = np.concatenate([base, base[:30], base[:5], base[:5]])
    q = codes[rng.integers(0, codes.shape[0], 64)].copy()
    q[::3, :4] = 0
    want = ScanRunner(codes, 60, mesh=build_mesh(1, 1)).best_hit(q, None)
    got = TorchRunner.from_codes(codes, 60, torch.device("cpu")).best_hit(q, None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_key_overflow_names_roadmap():
    """ScanRunner cannot pack 2^25 bp windows and names the runner that
    does; the layout choice builds that runner on the same codes."""
    import torch

    from smafa_tpu_torch.parallel.runner import KeyPackingError, ScanRunner
    from smafa_tpu_torch.parallel.select import make_runner
    from smafa_tpu_torch.parallel.wide import WideRunner

    codes = np.broadcast_to(np.zeros(1, np.uint8), (4, 2**25))
    with pytest.raises(KeyPackingError, match="parallel.wide.WideRunner"):
        ScanRunner(codes, 2**25, torch.device("cpu"))
    assert type(make_runner(codes, 2**25, torch.device("cpu"))) is WideRunner


def test_import_loads_no_jax_or_triton():
    """In a fresh interpreter: the session's own conftest imports jax."""
    code = ("import sys, smafa_tpu_torch, smafa_tpu_torch.cli, "
            "smafa_tpu_torch.engine.query, smafa_tpu_torch.engine.makedb, "
            "smafa_tpu_torch.parallel.runner, smafa_tpu_torch.ops.min2, "
            "smafa_tpu_torch.parallel.select, smafa_tpu_torch.parallel.slab, "
            "smafa_tpu_torch.ops.compact, smafa_tpu_torch.ops.min_count, "
            "smafa_tpu_torch.ops.kstats, smafa_tpu_torch.ops.dist_block, "
            "smafa_tpu_torch.ops.hist, "
            "smafa_tpu_torch.parallel.wide, "
            "smafa_tpu_torch.engine.cluster, smafa_tpu_torch.engine.count; "
            "smafa_tpu_torch.cluster, smafa_tpu_torch.count; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'smafa_tpu')); print(bad)")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=root)
    assert out.stdout.strip() == "[]"
