"""velocity_asr_tpu_torch/compare_trees.py on the CPU: the turns run in
their own processes, in the order asked, and their forward and backward
outputs are held against each other."""

import json
import os

import pytest

from velocity_asr_tpu_torch import compare_trees

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_turns_of_one_tree_agree_bit_for_bit(capsys):
    assert compare_trees.main([ROOT, ROOT, "--device", "cpu", "--order", "ABA"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["ok"] and result["device"] == "cpu"
    assert [t["letter"] for t in result["turns"]] == ["A", "B", "A"]
    # the forward's four entries, each saved by every turn: states bit-equal, y within 1e-4
    assert [(f["entry"], f["states_bit_equal"], f["y_max_rel"]) for f in result["forward"]] == [
        (entry, True, 0.0) for entry, *_ in compare_trees.FWD_CPU_SHAPES]
    for t in result["turns"]:
        assert [(f["entry"], f["shape"], f["outputs"]) for f in t["forward"]] == [
            (entry, [b, length, 16, n], {"scan_fwd_f32": 1, "scan_fwd_state_f32": 2,
                                          "scan_fwd_bounds_f32": 2,
                                          "scan_fwd_bounds_state_f32": 3}[entry])
            for entry, b, length, n in compare_trees.FWD_CPU_SHAPES]
        assert all("cpu_wall_ms" in f and "device_ms" not in f for f in t["forward"])
        assert [b["shape"] for b in t["backward"]] == [list(s) for s in compare_trees.CPU_SHAPES]
        assert "train" not in t and all("device_ms" not in b for b in t["backward"])
        # dx, ddt, dA, dB, dC, and dh0 with a carried state
        assert [len(b["sums"]) for b in t["backward"]] == [5, 6]
        # both int8 kernels (their plain version here) at each shape and type of x
        assert [(r["shape"], r["dtype"]) for r in t["int8"]] == [
            (list(s), d) for s in compare_trees.INT8_CPU_SHAPES for d in compare_trees.INT8_TYPES]
        for r in t["int8"]:
            assert len(r["sums"]) == 2 and all(v > 0 for v in r["sums"])
            assert "dynamic_cpu_wall_ms" in r and "dynamic_device_ms" not in r
    assert compare_trees._agree(result["turns"]) == 0.0
    assert any(line.startswith("turn B int8 (37, 50, 30) x bfloat16:") for line in lines)
    assert any(line.startswith("forward across turns scan_fwd_bounds_state_f32 (2, 20, 16, 8): "
                               "states (bounds, h_final) bit-equal; y max_rel 0.000e+00")
               for line in lines)


def test_forward_summary_takes_each_trees_median_and_spread():
    turns = [{"letter": letter, "forward": [{"entry": "scan_fwd_f32", "shape": [1, 200, 384, 64],
                                             "device_ms": d}]}
             for letter, d in (("A", 0.062), ("B", 0.016), ("B", 0.018), ("A", 0.064))]
    assert compare_trees._summary(turns, "forward", ("",)) == [
        "scan_fwd_f32 (1, 200, 384, 64): A median 0.0630 ms (spread 0.0020, 2 turns); "
        "B median 0.0170 ms (spread 0.0020, 2 turns)"]


def test_int8_summary_takes_each_trees_median_and_spread():
    turns = [{"letter": letter, "int8": [{"shape": [4800, 192, 192], "dtype": "float32",
                                          "dynamic_device_ms": d, "static_device_ms": d / 2}]}
             for letter, d in (("A", 0.018), ("B", 0.005), ("B", 0.007), ("A", 0.020),
                               ("A", 0.019), ("B", 0.006))]
    lines = compare_trees._summary(turns, "int8", ("dynamic_", "static_"))
    assert lines[0] == ("int8 dynamic (4800, 192, 192) x float32: A median 0.0190 ms (spread "
                        "0.0020, 3 turns); B median 0.0060 ms (spread 0.0020, 3 turns)")
    assert lines[1].startswith("int8 static (4800, 192, 192) x float32: A median 0.0095 ms")


def test_an_order_naming_a_missing_tree_is_refused():
    with pytest.raises(SystemExit):
        compare_trees.main([ROOT, "--device", "cpu", "--order", "AB"])
