"""The pairs tool: its arithmetic against ``statistics.quantiles`` worked
by hand, the order of sides and the seeds it gives a stub run, which runs
count, the clamp, and ``BENCHMARK.json``'s bound against the committed
record it was set from."""

import json
import statistics
import subprocess
import sys

import pytest

from fraudbench import harness, pairs

RECORD = harness.BENCH / "bounds" / "sequence_k32.cards1m.json"


def _quartiles_by_hand(values):
    # statistics.quantiles' default ("exclusive") method: the m-th cut
    # point sits at position m (n + 1) / 4 of the sorted values
    v = sorted(values)
    n = len(v)
    cuts = []
    for m in (1, 2, 3):
        pos = m * (n + 1) / 4
        j = min(max(int(pos), 1), n - 1)
        cuts.append(v[j - 1] + (pos - j) * (v[j] - v[j - 1]))
    return cuts


def _run(side, value, pair=0, rc=0, correct=True, first=False, setup=30.0):
    return {"side": side, "pair": pair, "rc": rc, "correct": correct,
            "first": first,
            "metrics": {"tx_per_s.seq": value, "setup_s": setup}}


@pytest.mark.parametrize("values", [
    [7.0, 7.2, 6.9, 7.5, 7.1, 6.6],
    [3.0, 1.0, 2.0, 5.0, 4.0, 8.0, 6.0],
    [10.0, 12.0],
])
def test_quartiles_and_spread_match_by_hand(values):
    q = pairs.quartiles(values)
    q1, med, q3 = _quartiles_by_hand(values)
    assert q["q1"] == pytest.approx(q1, rel=1e-12)
    assert q["median"] == pytest.approx(med, rel=1e-12)
    assert q["median"] == pytest.approx(statistics.median(values), rel=1e-12)
    assert q["q3"] == pytest.approx(q3, rel=1e-12)
    assert q["spread"] == pytest.approx((q3 - q1) / med, rel=1e-12)


def test_summary_gap_and_spreads():
    a = [7.0, 7.2, 6.9, 7.5, 7.1, 6.6]
    b = [6.8, 7.4, 7.0, 7.3, 6.7, 7.2]
    runs = [_run("A", x, i) for i, x in enumerate(a)] + \
        [_run("B", x, i) for i, x in enumerate(b)]
    s = pairs.summarize(runs)["tx_per_s.seq"]
    for side, vals in (("A", a), ("B", b)):
        q1, med, q3 = _quartiles_by_hand(vals)
        assert s[side]["spread"] == pytest.approx((q3 - q1) / med)
    ma, mb = statistics.median(a), statistics.median(b)
    assert s["gap"] == pytest.approx(abs(ma - mb) / ma)


def test_setup_leaves_out_each_sides_first_run():
    runs = [_run("A", 1.0, 0, first=True, setup=90.0),
            _run("B", 1.0, 0, first=True, setup=95.0)] + \
        [_run(side, 1.0, i, setup=30.0 + i) for i in (1, 2, 3)
         for side in "AB"]
    s = pairs.summarize(runs)["setup_s"]
    assert s["A"]["n"] == s["B"]["n"] == 3
    assert s["A"]["median"] == 32.0
    assert pairs.summarize(runs)["tx_per_s.seq"]["A"]["n"] == 4


@pytest.mark.parametrize("raw,bound", [
    (0.0004, 0.01), (0.0123, 0.013), (0.05, 0.05), (0.0501, 0.051),
    (0.1999999, 0.2), (0.31, 0.25), (0.25, 0.25)])
def test_clamp_and_round_up(raw, bound):
    assert pairs.clamp_bound(raw) == bound


def test_set_bound_takes_the_larger_of_spread_and_gap():
    def one_set(a, b):
        return {"runs": [_run("A", x, i) for i, x in enumerate(a)]
                + [_run("B", x, i) for i, x in enumerate(b)]}

    tight = [100.0, 100.1, 99.9, 100.0, 100.2, 99.8]
    shifted = [x * 1.08 for x in tight]
    # five times a spread of ~0.25% is under the 8% gap: the gap wins
    got = pairs.set_bound([one_set(tight, tight), one_set(tight, shifted)],
                          "tx_per_s.seq")
    assert got["sets"] == 2
    assert got["widest_gap"] == pytest.approx(0.08)
    assert got["bound"] == pairs.clamp_bound(got["widest_gap"])
    wide = [100.0, 104.0, 97.0, 101.0, 95.0, 103.0]
    got = pairs.set_bound([one_set(wide, wide)], "tx_per_s.seq")
    assert got["raw"] == pytest.approx(5 * got["widest_spread"])
    # a set that does not report the metric is not read
    assert pairs.set_bound([one_set(wide, wide), {"runs": []}],
                           "tx_per_s.seq")["sets"] == 1
    with pytest.raises(ValueError):
        pairs.set_bound([{"runs": []}], "tx_per_s.seq")


def test_last_line_and_what_is_kept():
    line = {"correct": True, "attempted": 655360, "failed": 0,
            "metrics": {"tx_per_s.seq": {"value": 7.1e6, "unit": "tx/s"},
                        "setup_s": {"value": 29.5, "unit": "s"}},
            "device": {"platform": "gpu", "kind": "x", "count": 1,
                       "memory_peak_bytes": 123, "window_s": 10.01},
            "stages_ms": {"host_prep": 3.1}, "warm_s": 9.5,
            "checks": {"prob_gap": {"value": 2e-7, "limit": 1e-4}}}
    out = pairs.last_line("noise\n{not json\n" + json.dumps(line) + "\n\n")
    kept = pairs.keep(out, 0)
    assert kept["metrics"] == {"tx_per_s.seq": 7.1e6, "setup_s": 29.5}
    assert kept["stages_ms"] == {"host_prep": 3.1}
    assert kept["warm_s"] == 9.5 and kept["window_s"] == 10.01
    assert kept["memory_peak_bytes"] == 123
    assert kept["checks"] == {"prob_gap": 2e-7}
    assert pairs.counts(kept)
    assert pairs.last_line("") is None
    assert pairs.last_line("a\nnot json") is None
    assert not pairs.counts(pairs.keep(None, 1))
    assert not pairs.counts(pairs.keep({**line, "correct": False}, 0))
    assert not pairs.counts(pairs.keep(line, 3))


STUB = """\
import json, os, sys
args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
seed = int(args["--seed"])
with open(os.path.join({log!r}), "a") as f:
    f.write(json.dumps({{"tree": {side!r}, "args": args,
                         "home": os.environ["HOME"],
                         "tmp": os.environ["TMPDIR"]}}) + "\\n")
if seed in {exit_on}:
    sys.exit(3)
rate = 1000.0 + seed % 7 + (5.0 if {side!r} == "B" else 0.0)
print("fraudbench: a line on stdout before the result")
print(json.dumps({{"correct": seed not in {wrong_on}, "attempted": 64,
                  "failed": 0,
                  "metrics": {{"tx_per_s.seq": {{"value": rate,
                                                "unit": "tx/s"}},
                              "setup_s": {{"value": 2.0, "unit": "s"}}}},
                  "device": {{"platform": "gpu", "kind": "stub",
                             "count": 1, "memory_peak_bytes": 1}},
                  "stages_ms": {{"sink_write": 1.0}}, "warm_s": 0.5,
                  "checks": {{}}}}))
"""


def _stub_tree(root, side, log, exit_on=(), wrong_on=()):
    tree = root / side
    (tree / "fraudbench").mkdir(parents=True)
    (tree / pairs.PORT).mkdir()
    (tree / "fraudbench" / "run.py").write_text(STUB.format(
        log=str(log), side=side, exit_on=set(exit_on) or "()",
        wrong_on=set(wrong_on) or "()"))
    return tree


def test_sides_alternate_and_seeds_pair_with_a_stub(tmp_path):
    log = tmp_path / "log.jsonl"
    trees = [_stub_tree(tmp_path, s, log) for s in pairs.SIDES]
    out = tmp_path / "set.json"
    rec = pairs.run_pairs("sequence_k32.cards1m", trees, 4, 2**31 + 5, out,
                          "s1")
    assert rec["session"] == "s1"
    calls = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [c["tree"] for c in calls] == list("ABBAABBA")
    seeds = [int(c["args"]["--seed"]) for c in calls]
    assert seeds[0::2] == seeds[1::2]
    assert len(set(seeds[0::2])) == 4
    assert all(s > 2**31 for s in seeds)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for c in calls:
        assert c["args"]["--workload"] == "sequence_k32.cards1m"
        assert c["args"]["--trace"] == "0"
        assert float(c["args"]["--seconds"]) == bench["run_seconds"]
        assert c["home"].startswith(str(tmp_path / c["tree"]))
        assert c["tmp"].startswith(str(tmp_path / c["tree"]))
    assert [r["first"] for r in rec["runs"]] == [True] * 2 + [False] * 6
    # the two stubs differ in one word, and so do their digests
    assert rec["digests"]["A"] != rec["digests"]["B"]
    assert json.loads(out.read_text())["runs"] == rec["runs"]
    s = rec["summary"]["tx_per_s.seq"]
    assert s["A"]["n"] == s["B"]["n"] == 4
    assert s["gap"] > 0


def test_a_run_that_fails_is_kept_and_not_counted(tmp_path):
    seed = 9_000_000_000
    log = tmp_path / "log.jsonl"
    trees = [_stub_tree(tmp_path, "A", log),
             _stub_tree(tmp_path, "B", log, exit_on=[seed + 1],
                        wrong_on=[seed + 2])]
    rec = pairs.run_pairs("sequence_k32.cards1m", trees, 4, seed)
    assert len(rec["runs"]) == 8
    bad = [r for r in rec["runs"] if not pairs.counts(r)]
    assert {(r["side"], r["seed"], r["rc"], r["correct"]) for r in bad} == {
        ("B", seed + 1, 3, None), ("B", seed + 2, 0, False)}
    assert all("stderr_tail" in r for r in bad)
    s = rec["summary"]["tx_per_s.seq"]
    assert s["A"]["n"] == 4 and s["B"]["n"] == 2


def test_merge_carries_the_sets_and_their_bound(tmp_path):
    log = tmp_path / "log.jsonl"
    trees = [_stub_tree(tmp_path, s, log) for s in pairs.SIDES]
    files = []
    for k, seed in enumerate((11, 1000)):
        f = tmp_path / f"set{k}.json"
        pairs.run_pairs("sequence_k32.cards1m", trees, 3, seed, f)
        files.append(f)
    out = tmp_path / "record.json"
    assert pairs.main(["--merge", *map(str, files), "--metric",
                       "tx_per_s.seq", "--commit", "abc",
                       "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["commit"] == "abc" and len(rec["sets"]) == 2
    assert rec["bound"] == pairs.set_bound(rec["sets"], "tx_per_s.seq")


def test_benchmark_bound_is_the_rule_on_the_record():
    rec = json.loads(RECORD.read_text())
    seq = [s for s in rec["sets"] if s["workload"] == "sequence_k32.cards1m"]
    assert len(seq) >= 4
    assert len({s["session"] for s in seq}) >= 2
    for s in seq:
        assert len({r["pair"] for r in s["runs"]}) >= 6
        assert s["digests"]["A"] == s["digests"]["B"]
    controls = {s["workload"] for s in rec["sets"]} - {
        "sequence_k32.cards1m"}
    assert controls == {"forest_t100_exact.cards1m",
                        "forest_t100_exact.cards64k"}
    got = pairs.set_bound(rec["sets"], "tx_per_s.seq")
    assert got == rec["bound"]
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bound = {m["name"]: m["bound"] for m in bench["end_to_end"]}
    assert bound["tx_per_s.seq"] == got["bound"]


def test_the_tool_loads_neither_torch_nor_the_program():
    # it never holds the card while a run does
    code = ("import sys; sys.path.insert(0, %r); import fraudbench.pairs; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', %r)))" % (str(harness.ROOT), pairs.PORT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
