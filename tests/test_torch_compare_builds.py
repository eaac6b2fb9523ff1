"""ops/compare_builds.py's helpers on the CPU (the script itself needs the
card): the per-output comparison, the library swap around one call, and
the seeded inputs, the full-EdgeBlock backward's cotangent among them."""
import pytest
import torch

from moldiff_tpu_torch.ops import build, compare_builds


def test_diff_counts_differing_elements_and_the_largest_difference():
    a = [torch.tensor([1.0, 2.0, 3.0]), torch.zeros(2, dtype=torch.bfloat16)]
    b = [torch.tensor([1.0, 2.5, 3.0]), torch.zeros(2, dtype=torch.bfloat16)]
    assert compare_builds.diff(a, b) == ([1, 0], [0.5, 0.0])


def test_run_with_swaps_the_library_for_one_call_and_restores_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    own = build.library
    seen = []
    assert compare_builds.run_with("other", lambda: seen.append(build.library()) or [1]) == [1]
    assert seen == ["other"] and build.library is own

    def fails():
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        compare_builds.run_with("other", fails)
    assert build.library is own


def test_inputs_are_seeded_and_carry_the_edge_cotangent():
    one = compare_builds.inputs(2, 8, seed=5, dn=32, de=16, device="cpu")
    two = compare_builds.inputs(2, 8, seed=5, dn=32, de=16, device="cpu")
    assert one["ct"].shape == one["e"].shape == (2, 8, 8, 16)
    assert one["ct"].dtype == torch.bfloat16
    assert all(torch.equal(one[k], two[k]) for k in one)
