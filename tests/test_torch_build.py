"""The port's kernel build (ops/build.py) and the step profiler's trace
summary (sample/profile_steps.py), on the CPU: a stand-in ``nvcc`` script
takes the place of the compiler, and a hand-made trace that of the card."""
import os
import stat

import pytest

from moldiff_tpu_torch.ops import build
from moldiff_tpu_torch.sample.profile_steps import summarize_trace


def _fake_nvcc(tmp_path, body: str) -> str:
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path.parent)


@pytest.fixture
def build_env(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(build, "build_log", [])

    def use(body: str):
        monkeypatch.setenv("PATH", _fake_nvcc(tmp_path, body) + os.pathsep + os.environ["PATH"])
        return tmp_path / "args.txt"
    return use


def test_build_is_one_nvcc_call_over_every_source(build_env, tmp_path):
    args_file = build_env(
        f'echo "$@" >> {tmp_path}/args.txt\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\necho "ptxas info : Used 96 registers"\n')
    lib = build.build()
    assert lib.read_text() == "lib\n"
    assert lib.parent.name == build.source_hash()
    calls = args_file.read_text().splitlines()
    assert len(calls) == 1
    for flag in ("arch=compute_90a,code=sm_90a", "-shared", "-fPIC", "-O3"):
        assert flag in calls[0]
    assert all(str(src) in calls[0] for src in build.sources())
    assert len(build.sources()) == 3
    assert "Used 96 registers" in build.build_log[0]
    # a finished build is reused, not rebuilt
    assert build.build() == lib
    assert len(args_file.read_text().splitlines()) == 1


def test_build_failure_raises_with_the_compiler_output(build_env):
    build_env('echo "node_block.cu(3): error: bad" >&2\nexit 2\n')
    with pytest.raises(RuntimeError, match="error: bad"):
        build.build()
    assert not any(build.BUILD_ROOT.glob("*/" + build.LIB_NAME))


def test_build_that_hangs_is_stopped(build_env, monkeypatch):
    build_env("exec sleep 30\n")
    monkeypatch.setattr(build, "COMPILE_TIMEOUT_S", 0.2)
    with pytest.raises(RuntimeError, match="did not finish within 0.2 s"):
        build.build()


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary_counts_busy_union_and_port_kernels():
    events = [
        _ev("kernel", "(anonymous namespace)::node_prep_kernel(NodeBlockArgs)", 0, 10),
        _ev("kernel", "(anonymous namespace)::node_pair_kernel(NodeBlockArgs)", 5, 20),
        _ev("kernel", "void at::native::elementwise_kernel<128>", 40, 10),
        _ev("gpu_memcpy", "Memcpy DtoH", 100, 4),
        _ev("cpu_op", "aten::linear", 0, 500),
        _ev("cuda_runtime", "cudaLaunchKernel", 0, 3),
    ]
    s = summarize_trace(events, steps=2, step_ms=0.1)
    # busy: [0, 25] + [40, 50] + [100, 104] = 39 us over 2 steps
    assert s["device_busy_ms"] == pytest.approx(0.0195)
    assert s["device_idle_share"] == pytest.approx(1 - 0.0195 / 0.1)
    assert s["launches"] == {"all": 1.5, "port": 1.0}
    assert s["port_kernel_ms"] == {"node_pair_kernel": pytest.approx(0.01),
                                   "node_prep_kernel": pytest.approx(0.005)}
    assert s["other_kernel_ms"] == pytest.approx(0.005)
    assert s["top_other"][0][0].startswith("void at::native::elementwise_kernel")


def test_trace_summary_without_device_events_says_so():
    s = summarize_trace([_ev("cpu_op", "aten::add", 0, 5)], steps=1, step_ms=1.0)
    assert s["device_busy_ms"] is None and "no device events" in s["note"]
