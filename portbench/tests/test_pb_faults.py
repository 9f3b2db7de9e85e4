"""``correct`` decides: on tiny cells on the CPU, a sound run is correct,
and a run whose timed path is broken underneath is not, once for each
fault a cell can have; the bfloat16 control fails too. (The cells run on
one chip, so no exchange between chips can be left out.)"""

import time

import pytest

import pb_tiny
from portbench import control, run

CELLS = ("zipf1m.mix", "zipf1m.manyword")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.make_root(str(tmp_path_factory.mktemp("root")))


def one_run(root, cell, seed=2**31 + 11):
    return run.run_cell(cell, seed, 1.5, False, device="cpu", root=root,
                        t_start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    line = one_run(root, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


def _patch_answers(monkeypatch, alter):
    from rucene_tpu_torch.search import searcher as searcher_mod

    orig = searcher_mod.IndexSearcher.search_batch_async

    def broken(self, queries, k=10, timeout_s=None, prune=None):
        return alter(self, orig, queries, k)

    monkeypatch.setattr(searcher_mod.IndexSearcher, "search_batch_async", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(root, cell, monkeypatch):
    """One hit of every answer points at the next doc where it is made."""
    from rucene_tpu_torch.search.searcher import ScoreDoc, TopDocs

    def alter(self, orig, queries, k):
        collect = orig(self, queries, k)

        def bad():
            out = []
            for td in collect():
                sd = list(td.score_docs)
                if sd:
                    sd[-1] = ScoreDoc(sd[-1].doc + 1, sd[-1].score)
                out.append(TopDocs(td.total_hits, sd))
            return out
        return bad

    _patch_answers(monkeypatch, alter)
    line = one_run(root, cell)
    assert not line["correct"]
    assert line["checks"]["rank_gap"]["value"] > line["checks"]["rank_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_not_correct(root, cell, monkeypatch):
    """Only the first half of each batch is searched; the rest come back
    with no hits."""
    from rucene_tpu_torch.search.searcher import TopDocs

    def alter(self, orig, queries, k):
        half = len(queries) // 2 or 1
        collect = orig(self, queries[:half], k)
        return lambda: collect() + [TopDocs(0, []) for _ in queries[half:]]

    _patch_answers(monkeypatch, alter)
    line = one_run(root, cell)
    assert not line["correct"]
    assert line["checks"]["count_err"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_is_not_correct(root, cell):
    """The reference in bfloat16 put in the program's place fails, on three
    seeds, where the program passes."""
    lines = list(control.readings(cell, [5, 2**31 + 3, 2**32 + 9], 1.0, device="cpu", root=root))
    assert len(lines) == 3
    for line in lines:
        assert line["program_correct"], line
        assert not line["control_correct"], line
        assert line["control"]["score_err"] > 10 * line["program"]["score_err"]
