"""The port's storage layer against rucene_tpu's, on the CPU: directories
and checksums, front coding, LZ4, the doc-values codec, segment files,
segments_N, live and doc-values update generations, lazy (mmap) open,
CheckIndex, and an index written by either package opened by the other.

The same docs and config written by both writers into two FSDirectorys
give byte-identical files (codec/files.py writes no time, uuid or random
field; both packages' native libraries are loaded, so both compress the
stored fields the same way).
"""

import os
import shutil

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu import native as ref_native
from rucene_tpu.codec import dv_codec as ref_dv
from rucene_tpu.index.merge import TieredMergePolicy as RefPolicy
from rucene_tpu.index.reader import open_directory_reader as ref_open
from rucene_tpu.index.writer import IndexWriter as RefWriter
from rucene_tpu.index.writer import IndexWriterConfig as RefConfig
from rucene_tpu.store import directory as ref_dir
from rucene_tpu.tools.check_index import check_index as ref_check
from rucene_tpu.util import front_coding as ref_fc
from rucene_tpu_torch import native
from rucene_tpu_torch.codec import dv_codec, files
from rucene_tpu_torch.index.merge import TieredMergePolicy
from rucene_tpu_torch.store import directory
from rucene_tpu_torch.tools.check_index import check_index, exorcise
from rucene_tpu_torch.util import front_coding, lz4_py
from tests.conftest import random_corpus
from tests.torch_hitcheck import assert_topdocs_strict

K_ALL = 1000


def _docs(P, n: int = 240, seed: int = 5):
    """Every field family: body text, a stored id, an IntPoint, a tag on
    one doc in three, numeric, binary and sorted doc values on some."""
    rng = np.random.default_rng(seed)
    texts = random_corpus(rng, n, min_len=3, max_len=30)
    out = []
    for i, t in enumerate(texts):
        d = P.Document()
        d.add(P.StringField("id", str(i), stored=True))
        d.add(P.TextField("body", t))
        d.add(P.StoredField("note", f"note {i}"))
        d.add(P.IntPoint("ts", int(rng.integers(0, 1000))))
        if i % 3 == 0:
            d.add(P.StringField("tag", f"c{i % 7}"))
        if i % 2 == 0:
            d.add(P.NumericDocValuesField("rank", int(rng.integers(-50, 5000))))
            d.add(P.BinaryDocValuesField("blob", f"b{i % 5}".encode()))
            d.add(P.SortedDocValuesField("cat", f"k{i % 4}"))
        out.append(d)
    return out


def _write(P, path: str, writer, config, merge_policy):
    """One history of writes: flushes, a commit, deletes by term and by
    query, doc-values updates, an update, a second commit, a merge, and a
    delete and an update on the merged segments."""
    d = (directory if P is T else ref_dir).FSDirectory(path)
    w = writer(d, config(max_buffered_docs=60, merge_policy=merge_policy(segs_per_tier=64),
                         merge_on_commit=False))
    for doc in _docs(P):
        w.add_document(doc)
    w.commit()
    w.delete_documents_by_term(P.Term("id", "7"))
    w.delete_documents_by_query(P.PointRangeQuery("ts", 100, 180))
    w.update_numeric_doc_value(P.Term("id", "10"), "rank", 123456)
    w.update_binary_doc_value(P.Term("id", "12"), "blob", b"patched")
    d2 = P.Document()
    d2.add(P.StringField("id", "20", stored=True))
    d2.add(P.TextField("body", "replacement alpha beta"))
    w.update_document(P.Term("id", "20"), d2)
    w.commit()
    w.force_merge(3)
    w.delete_documents_by_term(P.Term("id", "30"))
    w.update_numeric_doc_value(P.Term("id", "40"), "rank", -9)
    w.commit()
    w.close()
    return d


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same history written by each package into its own directory."""
    assert native.available and ref_native.available  # identical stored-field bytes need both
    root = tmp_path_factory.mktemp("store")
    ref = _write(R, str(root / "ref"), RefWriter, RefConfig, RefPolicy)
    port = _write(T, str(root / "port"), T.IndexWriter, T.IndexWriterConfig, TieredMergePolicy)
    return root, ref, port


def _rows(P):
    B = P.BooleanQuery
    tq = lambda t: P.TermQuery(P.Term("body", t))  # noqa: E731
    return [
        tq("alpha"),
        B().should(tq("beta")).should(tq("gamma")),
        B().must(tq("delta")).must(tq("fox")),
        P.PhraseQuery("body", ["alpha", "beta"]),
        B().must(tq("dog")).filter(P.PointRangeQuery("ts", 200, 600)),
        B().should(tq("lazy")).must_not(P.TermQuery(P.Term("tag", "c3"))),
    ]


# --- the pieces --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fs", "ram"])
def test_directory_roundtrip_and_checksum(tmp_path, kind):
    def make(mod, sub):
        return mod.FSDirectory(str(tmp_path / sub)) if kind == "fs" else mod.RAMDirectory()

    blobs = []
    for mod, sub in ((ref_dir, "ref"), (directory, "port")):
        d = make(mod, sub)
        out = d.create_output("x.bin")
        out.write_header("x.bin")
        out.write(b"payload \x00\x01\x02" * 40)
        out.write_footer()
        out.close()
        d.rename("x.bin", "y.bin")
        d.sync(["y.bin"])
        raw = d.read_file("y.bin")
        assert d.list_all() == ["y.bin"] and d.file_size("y.bin") == len(raw)
        assert mod.check_footer(raw, "x.bin") == b"payload \x00\x01\x02" * 40
        for at in (3, len(raw) // 2, len(raw) - 2):
            bad = bytearray(raw)
            bad[at] ^= 0x10
            with pytest.raises(mod.CorruptIndexError):
                mod.check_footer(bytes(bad), "x.bin")
        d.delete_file("y.bin")
        assert not d.file_exists("y.bin")
        blobs.append(raw)
    assert blobs[0] == blobs[1]


def test_front_coding_and_lz4():
    rng = np.random.default_rng(3)
    terms = sorted({"".join(rng.choice(list("abcdé"), int(rng.integers(1, 9)))) for _ in range(400)})
    blob = front_coding.encode_terms(terms)
    assert blob == ref_fc.encode_terms(terms)
    assert front_coding.decode_terms(blob) == terms == ref_fc.decode_terms(blob)
    assert front_coding.decode_terms(front_coding.encode_terms([])) == []
    raw = ("".join(rng.choice(list("ab cd"), 5000))).encode() + bytes(range(256))
    packed = native.lz4_compress(raw)
    assert packed == ref_native.lz4_compress(raw)
    assert native.lz4_decompress(packed, len(raw)) == raw
    assert lz4_py.lz4_decompress(packed, len(raw)) == raw


@pytest.mark.parametrize("vals", [
    np.arange(100, dtype=np.int64) * 7 - 3,  # affine
    np.array([5, 5, 9, 9, 5, -2] * 20, np.int64),  # table
    np.random.default_rng(1).integers(-(1 << 40), 1 << 40, 300),  # wide
    np.zeros(0, np.int64),
])
def test_dv_codec_numeric(vals):
    meta, arrays = dv_codec.encode_numeric(vals)
    rmeta, rarrays = ref_dv.encode_numeric(vals)
    assert meta == rmeta and arrays.keys() == rarrays.keys()
    assert all(np.array_equal(arrays[k], rarrays[k]) for k in arrays)
    assert np.array_equal(dv_codec.decode_numeric(meta, arrays), vals)


def test_dv_codec_binary():
    per_doc = [b"x" * (i % 5) if i % 3 else None for i in range(90)] + [b"", b"\x00\xff"]
    meta, arrays = dv_codec.encode_binary(per_doc)
    rmeta, rarrays = ref_dv.encode_binary(per_doc)
    assert meta == rmeta and all(np.array_equal(arrays[k], rarrays[k]) for k in arrays)
    assert dv_codec.decode_binary(meta, arrays) == per_doc


# --- whole indexes -----------------------------------------------------------


def test_writers_write_identical_files(written):
    root, ref, port = written
    names = sorted(os.listdir(root / "ref"))
    assert names == sorted(os.listdir(root / "port"))
    assert any(n.endswith(".liv") for n in names) and any(n.endswith(".dvu") for n in names)
    for n in names:
        if n == "write.lock":
            continue
        a = (root / "ref" / n).read_bytes()
        b = (root / "port" / n).read_bytes()
        assert a == b, n


@pytest.mark.parametrize("reader_pkg", ["port", "ref"])
@pytest.mark.parametrize("writer_pkg", ["port", "ref"])
def test_each_opens_the_others_index(written, writer_pkg, reader_pkg):
    """Both packages' answers over either package's files, against the
    reference's reader over its own files."""
    root, _ref, _port = written
    path = str(root / writer_pkg)
    want = R.IndexSearcher(ref_open(ref_dir.FSDirectory(str(root / "ref")))).search_batch(
        _rows(R), k=K_ALL
    )
    if reader_pkg == "port":
        reader = T.open_directory_reader(T.FSDirectory(path))
        got = T.IndexSearcher(reader, device="cpu").search_batch(_rows(T), k=K_ALL)
    else:
        reader = ref_open(ref_dir.FSDirectory(path))
        got = R.IndexSearcher(reader).search_batch(_rows(R), k=K_ALL)
    for g, w in zip(got, want):
        assert_topdocs_strict(g, w)
    assert any(w.total_hits for w in want)
    leaf = reader.leaves[-1]
    assert reader.document(leaf.doc_base)["note"] == f"note {reader.document(leaf.doc_base)['id']}"
    assert reader.num_docs == sum(lf.num_docs for lf in reader.leaves) < reader.max_doc


def test_reader_accessors_match_reference(written):
    """Stored fields, term vectors, the terms iterator and every doc-values
    accessor (updates applied) of the port's reader equal the reference's
    over the same committed files."""
    root, _ref, port = written
    mine = T.open_directory_reader(port).leaves
    theirs = ref_open(ref_dir.FSDirectory(str(root / "port"))).leaves
    assert [(a.name, a.max_doc, a.del_count) for a in mine] == [
        (b.name, b.max_doc, b.del_count) for b in theirs
    ]
    for a, b in zip(mine, theirs):
        assert np.array_equal(a.live, b.live) if b.live is not None else a.live is None
        assert [a.document(i) for i in range(a.max_doc)] == [b.document(i) for i in range(b.max_doc)]
        assert np.array_equal(a.numeric_doc_values("rank")[0], b.numeric_doc_values("rank")[0])
        assert np.array_equal(a.numeric_doc_values("rank")[1], b.numeric_doc_values("rank")[1])
        assert a.binary_doc_values("blob") == b.binary_doc_values("blob")
        sa, sb = a.sorted_doc_values("cat"), b.sorted_doc_values("cat")
        assert list(sa[0]) == list(sb[0]) and np.array_equal(sa[1], sb[1])
        assert np.array_equal(a.exists_mask("rank"), b.exists_mask("rank"))
        assert a.term_vector(0, "body") == b.term_vector(0, "body")
        ia, ib = a.terms_iterator("body"), b.terms_iterator("body")
        assert ia.seek_ceil("c") == ib.seek_ceil("c") and ia.term() == ib.term()
        seen = []
        while (t := ia.next()) is not None and len(seen) < 20:
            assert t == ib.next() and ia.doc_freq() == ib.doc_freq()
            pa, pb = ia.postings(with_positions=True), ib.postings(with_positions=True)
            assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
            seen.append(t)
        assert seen
    assert 123456 in np.concatenate([lf.numeric_doc_values("rank")[0] for lf in mine])


def test_check_index_clean_on_both(written):
    root, ref, port = written
    for d in (ref_dir.FSDirectory(str(root / "port")), ref):
        st = ref_check(d)
        assert st.clean, st.render()
    for d in (T.FSDirectory(str(root / "ref")), port):
        st = check_index(d)
        assert st.clean, st.render()
        assert [s.name for s in st.segments] == [s.name for s in ref_check(ref).segments]


def test_flipped_byte_raises_and_is_reported(written, tmp_path):
    root, _ref, port = written
    dst = tmp_path / "corrupt"
    shutil.copytree(root / "port", dst)
    seg = max((p for p in dst.iterdir() if p.suffix == ".seg"), key=lambda p: p.stat().st_size)
    blob = bytearray(seg.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    seg.write_bytes(bytes(blob))
    d = T.FSDirectory(str(dst))
    with pytest.raises(T.CorruptIndexError):
        files.read_segment(d, seg.stem, lazy=False)
    st = check_index(d)
    assert not st.clean and any(s.errors for s in st.segments)
    assert exorcise(d) == [seg.stem]
    infos = files.read_segments_file(d)
    assert seg.stem not in [i.name for i in infos.segments]
    assert check_index(d).clean


def test_lazy_open_serves_equal(written, monkeypatch):
    _root, _ref, port = written
    infos = files.read_segments_file(port)
    for info in infos.segments:
        lazy = files.read_segment(port, info.name, lazy=True)
        eager = files.read_segment(port, info.name, lazy=False)
        assert not lazy.data.flags.writeable
        assert np.array_equal(lazy.data, eager.data) and np.array_equal(lazy.positions, eager.positions)
        assert lazy.stored[1] == eager.stored[1]
    lazy_reader = T.open_directory_reader(port)
    monkeypatch.setenv("RUCENE_EAGER_SEG", "1")
    eager_reader = T.open_directory_reader(port)
    assert eager_reader.leaves[0].packed.data.flags.writeable
    a = T.IndexSearcher(lazy_reader, device="cpu").search_batch(_rows(T), k=K_ALL)
    b = T.IndexSearcher(eager_reader, device="cpu").search_batch(_rows(T), k=K_ALL)
    assert a == b


def test_offsets_payloads_and_index_lookup(tmp_path):
    """Term vectors, inline offsets and payloads written by both writers:
    identical files, and index/index_lookup over the port's reopened
    segment equals the reference's, position by position."""
    import struct

    from rucene_tpu.index.index_lookup import LeafIndexLookup as RefLookup
    from rucene_tpu_torch.index.index_lookup import LeafIndexLookup

    def write(P, writer, path):
        w = writer((directory if P is T else ref_dir).FSDirectory(str(path)))
        for t in ["alpha beta alpha", "beta gamma", "alpha"]:
            d = P.Document()
            d.add(P.TextField("body", t, stored=True, term_vectors=True))
            w.add_document(d)
        d = P.Document()
        d.add(P.TextField("pay", [
            P.Token("w", 0, 0, 1, payload=struct.pack(">i", 42)),
            P.Token("w", 1, 2, 3, payload=struct.pack(">f", 2.5)),
            P.Token("w", 2, 4, 5),
        ], offsets=True))
        w.add_document(d)
        w.commit()
        w.close()

    write(R, RefWriter, tmp_path / "ref")
    write(T, T.IndexWriter, tmp_path / "port")
    for n in sorted(os.listdir(tmp_path / "ref")):
        if n != "write.lock":
            assert (tmp_path / "ref" / n).read_bytes() == (tmp_path / "port" / n).read_bytes(), n
    mine = LeafIndexLookup(T.open_directory_reader(T.FSDirectory(str(tmp_path / "port"))).leaves[0])
    theirs = RefLookup(ref_open(ref_dir.FSDirectory(str(tmp_path / "ref"))).leaves[0])

    def view(lookup, field, term, doc):
        t = lookup[field][term]
        return (t.df, t.ttf, t.tf(doc), [
            (p.position, p.start_offset, p.end_offset, p.payload) for p in t.positions(doc)
        ])

    for field, term, doc in (("body", "alpha", 0), ("body", "beta", 1), ("body", "zeta", 0),
                             ("pay", "w", 3)):
        assert view(mine, field, term, doc) == view(theirs, field, term, doc)
    ps = mine["pay"]["w"].positions(3)
    assert ps[0].payload_as_int() == 42 and abs(ps[1].payload_as_float() - 2.5) < 1e-6
    a, b = mine.field_statistics("body"), theirs.field_statistics("body")
    assert (a.max_doc, a.doc_count, a.sum_total_term_freq) == (
        b.max_doc, b.doc_count, b.sum_total_term_freq)
