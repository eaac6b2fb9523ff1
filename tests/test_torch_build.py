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
    assert [p.name for p in build.sources()] == [
        "edge_block_full.cu", "edge_pair.cu", "edge_pair_bwd.cu", "fused_block.cu", "grad.cu",
        "node_block.cu", "node_block_bwd.cu", "pos_update.cu", "pos_update_bwd.cu"]
    assert "Used 96 registers" in build.build_log[0]
    # the headers (wgmma.cuh among them) are part of the version built
    assert "wgmma.cuh" in [p.name for p in build.CSRC.glob("*.cuh")]
    # a finished build is reused, not rebuilt
    assert build.build() == lib
    assert len(args_file.read_text().splitlines()) == 1


def test_ctypes_signatures_match_the_c_definitions():
    """Every exported function's ctypes argument list has as many entries as
    its C definition has parameters (a pointer where the C side takes one):
    a missing int shifts every later argument."""
    import re

    text = "".join(p.read_text() for p in build.sources())
    for name, argtypes in {**build.SIGNATURES, **build.WORKSPACE_SIGNATURES,
                           **build.HOOK_SIGNATURES}.items():
        found = re.search(r"\b(?:int|long long) " + name + r"\(([^)]*)\)", text)
        assert found, name
        params = [p.strip() for p in found.group(1).split(",")]
        assert len(params) == len(argtypes), (name, params)
        for param, argtype in zip(params, argtypes):
            assert ("*" in param) == (argtype is build._P), (name, param)
    # the two backward entry points take the modes' flags before the stream
    assert build.SIGNATURES["md_node_block_backward"][-4:-2] == [build._I, build._I]
    assert build.SIGNATURES["md_edge_pair_backward"][-4:-2] == [build._I, build._I]


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


def test_trace_summary_keeps_torch_reductions_out_of_port_kernels():
    """PyTorch's reductions are also named reduce_kernel; only the port's
    (anonymous-namespace) kernels count as the port's."""
    events = [
        _ev("kernel", "(anonymous namespace)::reduce_kernel(ReduceTable)", 0, 4),
        _ev("kernel", "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", 10, 6),
        _ev("kernel", "(anonymous namespace)::pos_bwd_pair_kernel(PosBwdArgs)", 20, 8),
    ]
    s = summarize_trace(events, steps=1, step_ms=1.0)
    assert s["launches"] == {"all": 3.0, "port": 2.0}
    assert s["port_kernel_ms"] == {"pos_bwd_pair_kernel": pytest.approx(0.008),
                                   "reduce_kernel": pytest.approx(0.004)}
    assert s["other_kernel_ms"] == pytest.approx(0.006)


def test_trace_summary_counts_the_whole_block_and_edge_tail_kernels():
    """The kernels of the whole-block and full-EdgeBlock entry points
    (fused_block.cu, edge_block_full.cu) count as the port's, each template
    instantiation under its kernel's name."""
    events = [
        _ev("kernel", "void (anonymous namespace)::edge_emb_kernel<64>(EmbArgs)", 0, 2),
        _ev("kernel", "void (anonymous namespace)::node_tail_kernel<256, 256>(NodeTailArgs)",
            2, 3),
        _ev("kernel", "void (anonymous namespace)::tail_prep_kernel<64>(TailArgs)", 5, 1),
        _ev("kernel", "void (anonymous namespace)::tail_fwd_kernel<64>(TailArgs)", 6, 4),
        _ev("kernel", "void (anonymous namespace)::tail_bwd_pair_kernel<64>(TailArgs)", 10, 5),
        _ev("kernel", "void (anonymous namespace)::tail_bwd_node_kernel<64>(TailArgs)", 15, 2),
        _ev("kernel", "void (anonymous namespace)::tail_fwd_kernel<32>(TailArgs)", 17, 2),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", 20, 1),
    ]
    s = summarize_trace(events, steps=1, step_ms=1.0)
    assert s["launches"] == {"all": 8.0, "port": 7.0}
    assert sorted(s["port_kernel_ms"]) == ["edge_emb_kernel", "node_tail_kernel",
                                           "tail_bwd_node_kernel", "tail_bwd_pair_kernel",
                                           "tail_fwd_kernel", "tail_prep_kernel"]
    assert s["port_kernel_ms"]["tail_fwd_kernel"] == pytest.approx(0.006)
    assert s["other_kernel_ms"] == pytest.approx(0.001)
