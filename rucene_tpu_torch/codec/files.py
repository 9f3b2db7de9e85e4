"""On-disk segment format.

One section-based container per segment (`<name>.seg`) instead of the
reference's 10+ codec streams (rucene Lucene62Codec, codec/mod.rs:231-262):
the packed block tensors are the on-disk AND in-HBM layout, so reading a
segment is a TOC walk + zero-copy numpy views. Live docs travel separately
(`<name>_<gen>.liv`, analog of Lucene50LiveDocsFormat) so deletes never
rewrite postings. `segments_N` is the two-phase commit point
(segment_infos.rs:60-69,196).

Container layout (all framed by store.directory header/footer + CRC32):
  payload := sections...; TOC(json: name -> [offset_in_payload, length, kind])
  section kinds: "npy" (numpy, no pickle), "json", "zjson" (zlib json)
Port changes (held against rucene_tpu/codec/files.py by
tests/test_torch_host.py):
- LazyStored.__reduce__: a LazyStored pickles as the list of its docs (a
  merge that runs in a worker process gets its inputs pickled; the mmap
  under the view does not pickle).
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from rucene_tpu_torch.codec.postings import PackedField, PackedSegment
from rucene_tpu_torch.doc.field import DocValuesType, IndexOptions
from rucene_tpu_torch.index.field_infos import FieldInfo, FieldInfos
from rucene_tpu_torch.index.memory import FieldStats
from rucene_tpu_torch.store.directory import ChecksumOutput, Directory, check_footer

STORED_CHUNK = 128  # docs per compressed stored-fields chunk


# ---------------- section container ----------------


class SectionWriter:
    def __init__(self, out: ChecksumOutput):
        self.out = out
        self.toc: dict[str, tuple[int, int, str]] = {}
        self._base = out.position

    def _add(self, name: str, payload: bytes, kind: str) -> None:
        off = self.out.position - self._base
        self.out.write(payload)
        self.toc[name] = (off, len(payload), kind)

    def add_npy(self, name: str, arr: np.ndarray) -> None:
        buf = io.BytesIO()
        np.lib.format.write_array(buf, np.ascontiguousarray(arr), allow_pickle=False)
        self._add(name, buf.getvalue(), "npy")

    def add_json(self, name: str, obj) -> None:
        self._add(name, json.dumps(obj, separators=(",", ":")).encode("utf-8"), "json")

    def add_zjson(self, name: str, obj) -> None:
        """JSON section compressed with native LZ4 when available (reference
        compression.rs LZ4 for stored fields/TV), zlib otherwise."""
        from rucene_tpu_torch import native

        raw = json.dumps(obj, separators=(",", ":")).encode("utf-8")
        if native.available:
            blob = struct.pack("<Q", len(raw)) + native.lz4_compress(raw)
            self._add(name, blob, "lz4json")
        else:
            self._add(name, zlib.compress(raw, 6), "zjson")

    def finish(self) -> None:
        toc_bytes = json.dumps(self.toc, separators=(",", ":")).encode("utf-8")
        toc_off = self.out.position - self._base
        self.out.write(toc_bytes)
        self.out.write(struct.pack("<QQ", toc_off, len(toc_bytes)))


class SectionReader:
    """TOC'd section access over a file image. With a memoryview payload
    (mmap open), npy() returns ZERO-COPY array views — pages fault in on
    first touch, so opening a multi-GB segment costs milliseconds
    (reference mmap_index_input.rs:126)."""

    def __init__(self, payload):
        # lazy (mmap) opens skip the whole-file CRC, so TOC/section parses
        # are a corruption boundary: damaged bytes must surface as
        # CorruptIndexError, not arbitrary parser exceptions
        try:
            toc_off, toc_len = struct.unpack_from(
                "<QQ", payload, len(payload) - 16
            )
            self.toc: dict[str, list] = json.loads(
                bytes(payload[toc_off : toc_off + toc_len])
            )
        except (struct.error, ValueError, UnicodeDecodeError) as e:
            from rucene_tpu_torch.store.directory import CorruptIndexError

            raise CorruptIndexError(f"bad section TOC: {e}") from None
        self.payload = payload
        self.lazy = isinstance(payload, memoryview)

    def __contains__(self, name: str) -> bool:
        return name in self.toc

    def npy(self, name: str) -> np.ndarray:
        off, ln, kind = self.toc[name]
        assert kind == "npy"
        buf = self.payload[off : off + ln]
        if self.lazy:
            return _npy_view(buf)
        return np.lib.format.read_array(io.BytesIO(buf), allow_pickle=False)

    def json(self, name: str):
        try:
            off, ln, kind = self.toc[name]
            blob = bytes(self.payload[off : off + ln])
            if kind == "json":
                return json.loads(blob)
            if kind == "lz4json":
                from rucene_tpu_torch import native

                (orig,) = struct.unpack_from("<Q", blob, 0)
                if native.available:
                    return json.loads(native.lz4_decompress(blob[8:], orig))
                from rucene_tpu_torch.util.lz4_py import lz4_decompress

                return json.loads(lz4_decompress(blob[8:], orig))
            assert kind == "zjson"
            return json.loads(zlib.decompress(blob))
        except (ValueError, struct.error, zlib.error, AssertionError,
                UnicodeDecodeError, KeyError) as e:
            from rucene_tpu_torch.store.directory import CorruptIndexError

            raise CorruptIndexError(f"bad json section {name!r}: {e}") from None


def _npy_view(buf) -> np.ndarray:
    """Zero-copy .npy parse: header from the first bytes, data as a
    read-only view into the underlying buffer (no object dtypes are ever
    written — write_segment uses allow_pickle=False throughout).

    A corrupt header raises whatever numpy's parser throws (ValueError,
    tokenize.TokenError via its ast safe-eval, ...) — normalize ALL of it
    to CorruptIndexError; this is the lazy path's detection boundary."""
    import numpy.lib.format as npfmt

    from rucene_tpu_torch.store.directory import CorruptIndexError

    try:
        bio = io.BytesIO(bytes(buf[: min(len(buf), 1024)]))
        version = npfmt.read_magic(bio)
        if version == (1, 0):
            shape, fortran, dtype = npfmt.read_array_header_1_0(bio)
        else:
            shape, fortran, dtype = npfmt.read_array_header_2_0(bio)
        off = bio.tell()
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=off)
        return arr.reshape(shape, order="F" if fortran else "C")
    except CorruptIndexError:
        raise
    except Exception as e:
        raise CorruptIndexError(f"bad npy section: {e}") from None


class LazyStored:
    """Sequence view over compressed stored-field chunks: a chunk is
    decompressed on first access (LRU of a few chunks), so opening a
    segment never inflates the whole row store (the reference reads
    .fdt chunks on demand the same way, stored_fields_reader.rs)."""

    def __init__(self, reader: "SectionReader", n_docs: int, n_chunks: int):
        self._r = reader
        self._n = n_docs
        self._chunks: dict[int, list] = {}
        self._order: list[int] = []

    def _chunk(self, c: int) -> list:
        got = self._chunks.get(c)
        if got is None:
            got = self._r.json(f"stored.{c}")
            self._chunks[c] = got
            self._order.append(c)
            if len(self._order) > 8:  # keep a few hot chunks
                old = self._order.pop(0)
                self._chunks.pop(old, None)
        return got

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._chunk(i // STORED_CHUNK)[i % STORED_CHUNK]

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def __eq__(self, other):
        return list(self) == list(other)

    def __reduce__(self):
        return list, (list(self),)


# ---------------- term table (offsets + bytes; front-coding TBD) -------------


def _terms_to_arrays(terms: list[str]) -> tuple[np.ndarray, np.ndarray]:
    blobs = [t.encode("utf-8") for t in terms]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    if blobs:
        offsets[1:] = np.cumsum([len(b) for b in blobs])
    data = b"".join(blobs)
    return offsets, np.frombuffer(data, dtype=np.uint8).copy()


def _terms_from_arrays(offsets: np.ndarray, data: np.ndarray) -> list[str]:
    raw = data.tobytes()
    return [raw[offsets[i] : offsets[i + 1]].decode("utf-8") for i in range(len(offsets) - 1)]


# ---------------- segment write/read ----------------


def segment_file(name: str) -> str:
    return f"{name}.seg"


def live_file(name: str, gen: int) -> str:
    return f"{name}_{gen}.liv"


def write_segment(directory: Directory, name: str, packed: PackedSegment) -> str:
    fname = segment_file(name)
    out = directory.create_output(fname)
    out.write_header(fname)
    w = SectionWriter(out)

    from rucene_tpu_torch.util.front_coding import encode_terms

    field_meta = []
    for fname_, pf in sorted(packed.fields.items(), key=lambda kv: kv[1].field_id):
        field_meta.append({"name": fname_, "field_id": pf.field_id})
        pre = f"f{pf.field_id}."
        w.add_npy(pre + "terms_fc", np.frombuffer(encode_terms(pf.terms), np.uint8).copy())
        w.add_npy(pre + "doc_freq", pf.doc_freq)
        w.add_npy(pre + "total_tf", pf.total_tf)
        w.add_npy(pre + "block_start", pf.block_start)
        w.add_npy(pre + "block_count", pf.block_count)
        w.add_npy(pre + "pos_start", pf.pos_start)
        w.add_npy(pre + "pos_width", pf.pos_width)
        w.add_npy(pre + "pos_word_start", pf.pos_word_start)

    infos = [
        {
            "name": fi.name,
            "number": fi.number,
            "index_options": int(fi.index_options),
            "dv": int(fi.doc_values_type),
            "omit_norms": fi.omit_norms,
        }
        for fi in packed.field_infos
    ]
    w.add_json(
        "meta",
        {
            "max_doc": packed.max_doc,
            "fields": field_meta,
            "field_infos": infos,
            "stats": {
                f: {"doc_count": s.doc_count, "sum_ttf": s.sum_total_term_freq, "sum_df": s.sum_doc_freq}
                for f, s in packed.stats.items()
            },
            "norm_fields": sorted(packed.norms),
            "dv_fields": sorted(packed.numeric_dv),
            "point_fields": sorted(packed.points),
            "bdv_fields": sorted(packed.binary_dv or {}),
            "sdv_fields": sorted(packed.sorted_dv or {}),
            "sndv_fields": sorted(packed.sorted_numeric_dv or {}),
            "ssdv_fields": sorted(packed.sorted_set_dv or {}),
        },
    )
    for key in ("blk_off", "blk_doc_bits", "blk_freq_bits", "blk_base", "blk_count",
                "blk_max_freq", "blk_first_doc", "blk_last_doc", "blk_pos_base",
                "data", "positions"):
        w.add_npy(key, getattr(packed, key))
    if packed.off_starts is not None:
        w.add_npy("off_starts", packed.off_starts)
        w.add_npy("off_ends", packed.off_ends)
    if packed.pay is not None:
        # payload plane: flat bytes + occurrence offsets (empty == absent)
        blobs = [p or b"" for p in packed.pay]
        offs = np.zeros(len(blobs) + 1, np.int64)
        if blobs:
            offs[1:] = np.cumsum([len(b) for b in blobs])
        w.add_npy("pay_blob", np.frombuffer(b"".join(blobs), np.uint8).copy())
        w.add_npy("pay_offs", offs)
    for f in sorted(packed.norms):
        w.add_npy(f"norms.{f}", packed.norms[f])
    from rucene_tpu_torch.codec.dv_codec import encode_binary, encode_numeric

    for f in sorted(packed.numeric_dv):
        vals, present = packed.numeric_dv[f]
        # compressed numeric column (const/table/gcd/raw — Lucene54
        # doc_values_consumer.rs strategy menu); present as a bitmap
        nmeta, narrs = encode_numeric(np.asarray(vals))
        w.add_json(f"dv.{f}.meta", nmeta)
        for kk, arr in narrs.items():
            w.add_npy(f"dv.{f}.{kk}", arr)
        w.add_npy(f"dv.{f}.pbits", np.packbits(np.asarray(present, bool)))
    for f in sorted(packed.points):
        vals, docs = packed.points[f]
        w.add_npy(f"pt.{f}.vals", vals)
        w.add_npy(f"pt.{f}.docs", docs)
    if packed.binary_dv:
        for f, per_doc in sorted(packed.binary_dv.items()):
            # prefix-compressed + deflated (BINARY_PREFIX_COMPRESSED analog)
            bmeta, barrs = encode_binary(list(per_doc))
            w.add_json(f"bdv.{f}.meta", bmeta)
            for kk, arr in barrs.items():
                w.add_npy(f"bdv.{f}.{kk}", arr)
    if packed.sorted_dv:
        for f, (values, ords) in sorted(packed.sorted_dv.items()):
            w.add_npy(
                f"sdv.{f}.vfc",
                np.frombuffer(encode_terms(values), np.uint8).copy(),
            )
            w.add_npy(f"sdv.{f}.ords", ords)
    if packed.sorted_numeric_dv:
        for f, (flat, offs) in sorted(packed.sorted_numeric_dv.items()):
            w.add_npy(f"sndv.{f}.flat", flat)
            w.add_npy(f"sndv.{f}.offs", offs)
    if packed.sorted_set_dv:
        for f, (values, flat_ords, offs) in sorted(packed.sorted_set_dv.items()):
            w.add_npy(
                f"ssdv.{f}.vfc",
                np.frombuffer(encode_terms(values), np.uint8).copy(),
            )
            w.add_npy(f"ssdv.{f}.ords", flat_ords)
            w.add_npy(f"ssdv.{f}.offs", offs)

    # stored fields: zlib-json chunks
    n_chunks = (len(packed.stored) + STORED_CHUNK - 1) // STORED_CHUNK
    w.add_json("stored.nchunks", n_chunks)
    for c in range(n_chunks):
        w.add_zjson(f"stored.{c}", packed.stored[c * STORED_CHUNK : (c + 1) * STORED_CHUNK])

    # term vectors (.tvd analog): zlib-json chunks, present only if stored
    if packed.term_vectors is not None:
        tv_chunks = (len(packed.term_vectors) + STORED_CHUNK - 1) // STORED_CHUNK
        w.add_json("tv.nchunks", tv_chunks)
        for c in range(tv_chunks):
            w.add_zjson(f"tv.{c}", packed.term_vectors[c * STORED_CHUNK : (c + 1) * STORED_CHUNK])

    w.finish()
    out.write_footer()
    out.close()
    return fname


def _read_payload_plane(r: "SectionReader") -> np.ndarray:
    blob = r.npy("pay_blob").tobytes()
    offs = r.npy("pay_offs")
    out = np.empty(len(offs) - 1, dtype=object)
    for i in range(len(offs) - 1):
        a, z = int(offs[i]), int(offs[i + 1])
        out[i] = blob[a:z] if z > a else None
    return out


def _fallback_block_ranges(r, fields) -> tuple[np.ndarray, np.ndarray]:
    """Sound block doc-range reconstruction for pre-v3 .seg files that lack
    blk_first_doc/blk_last_doc: first = blk_base+1 (loose for list heads),
    last = next block's base within a term, open (INT32_MAX) for each
    term's final block."""
    blk_base = r.npy("blk_base").astype(np.int64)
    nb = len(blk_base)
    firsts = blk_base + 1
    lasts = np.full(nb, np.int64(2**31 - 1))
    for pf in fields.values():
        bs = pf.block_start.astype(np.int64)
        bc = pf.block_count.astype(np.int64)
        for s, c in zip(bs, bc):
            if c > 1:
                lasts[s : s + c - 1] = blk_base[s + 1 : s + c]
    return firsts.astype(np.int32), lasts.astype(np.int32)


def _read_numeric_dv(r: "SectionReader", f: str, max_doc: int):
    """Compressed (v3) or raw (v2) numeric DV column."""
    if f"dv.{f}.meta" in r:
        from rucene_tpu_torch.codec.dv_codec import decode_numeric

        nmeta = r.json(f"dv.{f}.meta")
        arrays = {
            kk: r.npy(f"dv.{f}.{kk}")
            for kk in ("table", "packed", "raw")
            if f"dv.{f}.{kk}" in r
        }
        vals = decode_numeric(nmeta, arrays)
        present = np.unpackbits(r.npy(f"dv.{f}.pbits"))[: len(vals)].astype(bool)
        return vals, present
    return r.npy(f"dv.{f}.vals"), r.npy(f"dv.{f}.present")


def _read_dv_values(r: "SectionReader", pre: str) -> list[str]:
    """Front-coded (v3) or raw-offset (v2) sorted-DV value dictionary."""
    if f"{pre}.vfc" in r:
        from rucene_tpu_torch.util.front_coding import decode_terms

        return decode_terms(r.npy(f"{pre}.vfc").tobytes())
    return _terms_from_arrays(r.npy(f"{pre}.voffs"), r.npy(f"{pre}.vbytes"))


def read_segment(
    directory: Directory, name: str, lazy: bool | None = None
) -> PackedSegment:
    """Open a packed segment. lazy=None (default) memory-maps when the
    directory supports it (FSDirectory): sections become zero-copy views
    that fault in on first touch and the whole-file CRC pass is skipped —
    opening an 855 MB index costs seconds, not a minute (VERDICT r2 item
    8; reference mmap_index_input.rs:126 — Lucene likewise verifies
    checksums only in CheckIndex/merge, never on open). lazy=False (or
    RUCENE_EAGER_SEG=1) restores the eager CRC-verified read."""
    import os as _os

    fname = segment_file(name)
    if lazy is None:
        lazy = _os.environ.get("RUCENE_EAGER_SEG") != "1" and hasattr(
            directory, "mmap_file"
        )
    if lazy and hasattr(directory, "mmap_file"):
        from rucene_tpu_torch.store.directory import check_footer_lazy

        payload = check_footer_lazy(directory.mmap_file(fname), fname)
    else:
        payload = check_footer(directory.read_file(fname), fname)
    r = SectionReader(payload)
    meta = r.json("meta")

    field_infos = FieldInfos()
    for fi in meta["field_infos"]:
        info = FieldInfo(
            name=fi["name"],
            number=fi["number"],
            index_options=IndexOptions(fi["index_options"]),
            doc_values_type=DocValuesType(fi["dv"]),
            omit_norms=fi["omit_norms"],
        )
        field_infos.by_name[info.name] = info

    from rucene_tpu_torch.util.front_coding import decode_terms

    fields: dict[str, PackedField] = {}
    for fm in meta["fields"]:
        pre = f"f{fm['field_id']}."
        if (pre + "terms_fc") in r:
            terms = decode_terms(r.npy(pre + "terms_fc").tobytes())
        else:  # older files: raw offsets + bytes
            terms = _terms_from_arrays(r.npy(pre + "term_offsets"), r.npy(pre + "term_bytes"))
        fields[fm["name"]] = PackedField(
            name=fm["name"],
            field_id=fm["field_id"],
            terms=terms,
            term_ord={t: i for i, t in enumerate(terms)},
            doc_freq=r.npy(pre + "doc_freq"),
            total_tf=r.npy(pre + "total_tf"),
            block_start=r.npy(pre + "block_start"),
            block_count=r.npy(pre + "block_count"),
            pos_start=r.npy(pre + "pos_start"),
            pos_width=r.npy(pre + "pos_width") if (pre + "pos_width") in r else None,
            pos_word_start=(
                r.npy(pre + "pos_word_start") if (pre + "pos_word_start") in r else None
            ),
        )

    stats = {
        f: FieldStats(doc_count=s["doc_count"], sum_total_term_freq=s["sum_ttf"], sum_doc_freq=s["sum_df"])
        for f, s in meta["stats"].items()
    }
    stored = LazyStored(r, meta["max_doc"], r.json("stored.nchunks"))

    term_vectors = None
    if "tv.nchunks" in r:
        term_vectors = []
        for c in range(r.json("tv.nchunks")):
            term_vectors.extend(r.json(f"tv.{c}"))

    return PackedSegment(
        max_doc=meta["max_doc"],
        field_infos=field_infos,
        fields=fields,
        stats=stats,
        blk_off=r.npy("blk_off"),
        blk_doc_bits=r.npy("blk_doc_bits"),
        blk_freq_bits=r.npy("blk_freq_bits"),
        blk_base=r.npy("blk_base"),
        blk_count=r.npy("blk_count"),
        blk_max_freq=r.npy("blk_max_freq"),
        blk_first_doc=(
            r.npy("blk_first_doc")
            if "blk_first_doc" in r
            else _fallback_block_ranges(r, fields)[0]
        ),
        blk_last_doc=(
            r.npy("blk_last_doc")
            if "blk_last_doc" in r
            else _fallback_block_ranges(r, fields)[1]
        ),
        blk_pos_base=r.npy("blk_pos_base"),
        data=r.npy("data"),
        positions=r.npy("positions"),
        off_starts=r.npy("off_starts") if "off_starts" in r else None,
        off_ends=r.npy("off_ends") if "off_ends" in r else None,
        pay=_read_payload_plane(r) if "pay_offs" in r else None,
        norms={f: r.npy(f"norms.{f}") for f in meta["norm_fields"]},
        stored=stored,
        numeric_dv={
            f: _read_numeric_dv(r, f, meta["max_doc"]) for f in meta["dv_fields"]
        },
        points={
            f: (r.npy(f"pt.{f}.vals"), r.npy(f"pt.{f}.docs"))
            for f in meta.get("point_fields", [])
        },
        term_vectors=term_vectors,
        binary_dv=(
            {
                f: _read_binary_dv(r, f)
                for f in meta.get("bdv_fields", [])
            }
            or None
        ),
        sorted_dv=(
            {
                f: (_read_dv_values(r, f"sdv.{f}"), r.npy(f"sdv.{f}.ords"))
                for f in meta.get("sdv_fields", [])
            }
            or None
        ),
        sorted_numeric_dv=(
            {
                f: (r.npy(f"sndv.{f}.flat"), r.npy(f"sndv.{f}.offs"))
                for f in meta.get("sndv_fields", [])
            }
            or None
        ),
        sorted_set_dv=(
            {
                f: (
                    _read_dv_values(r, f"ssdv.{f}"),
                    r.npy(f"ssdv.{f}.ords"),
                    r.npy(f"ssdv.{f}.offs"),
                )
                for f in meta.get("ssdv_fields", [])
            }
            or None
        ),
    )


def dvu_file(name: str, gen: int) -> str:
    return f"{name}_{gen}.dvu"


def write_dv_updates(
    directory: Directory,
    name: str,
    gen: int,
    updates: dict[str, dict[int, int]],
    binary_updates: dict[str, dict[int, bytes]] | None = None,
) -> str:
    """Sparse numeric + binary doc-values updates for one segment generation
    (reference doc_values_update.rs — per-gen DV update files)."""
    import base64

    fname = dvu_file(name, gen)
    out = directory.create_output(fname)
    out.write_header(fname)
    obj = {
        "numeric": {
            f: {str(d): int(v) for d, v in m.items()} for f, m in updates.items()
        },
        "binary": {
            f: {
                str(d): base64.b64encode(v).decode("ascii") for d, v in m.items()
            }
            for f, m in (binary_updates or {}).items()
        },
    }
    out.write(zlib.compress(json.dumps(obj, separators=(",", ":")).encode("utf-8"), 6))
    out.write_footer()
    out.close()
    return fname


def read_dv_updates(
    directory: Directory, name: str, gen: int
) -> tuple[dict[str, dict[int, int]], dict[str, dict[int, bytes]]]:
    import base64

    fname = dvu_file(name, gen)
    payload = check_footer(directory.read_file(fname), fname)
    obj = json.loads(zlib.decompress(payload))
    if "numeric" not in obj:  # v2 files: numeric-only flat map
        return (
            {f: {int(d): int(v) for d, v in m.items()} for f, m in obj.items()},
            {},
        )
    return (
        {
            f: {int(d): int(v) for d, v in m.items()}
            for f, m in obj["numeric"].items()
        },
        {
            f: {int(d): base64.b64decode(v) for d, v in m.items()}
            for f, m in obj["binary"].items()
        },
    )


def write_live(directory: Directory, name: str, gen: int, live: np.ndarray) -> str:
    fname = live_file(name, gen)
    out = directory.create_output(fname)
    out.write_header(fname)
    out.write(struct.pack("<Q", len(live)))
    out.write(np.packbits(live.astype(bool)).tobytes())
    out.write_footer()
    out.close()
    return fname


def read_live(directory: Directory, name: str, gen: int) -> np.ndarray:
    fname = live_file(name, gen)
    payload = check_footer(directory.read_file(fname), fname)
    (n,) = struct.unpack_from("<Q", payload, 0)
    bits = np.frombuffer(payload[8:], dtype=np.uint8)
    return np.unpackbits(bits)[:n].astype(bool)


def _read_binary_dv(r: SectionReader, f: str) -> list:
    if f"bdv.{f}.meta" in r:  # v3: prefix-compressed + deflated
        from rucene_tpu_torch.codec.dv_codec import decode_binary

        return decode_binary(
            r.json(f"bdv.{f}.meta"),
            {
                kk: r.npy(f"bdv.{f}.{kk}")
                for kk in ("present", "plens", "slens", "zblob")
            },
        )
    blob = r.npy(f"bdv.{f}.blob").tobytes()
    offs = r.npy(f"bdv.{f}.offs")
    present = r.npy(f"bdv.{f}.present")
    return [
        blob[offs[d] : offs[d + 1]] if present[d] else None for d in range(len(present))
    ]


# ---------------- commit metadata (segments_N) ----------------


@dataclass
class SegmentCommitInfo:
    name: str
    max_doc: int
    del_gen: int = -1  # -1 => no deletes
    del_count: int = 0
    dv_gen: int = -1  # -1 => no doc-values updates
    # lightweight shape metadata (num_blocks/data_words/pos_words/fields):
    # lets a multi-host process compute every shard's padded array shapes
    # WITHOUT reading unowned .seg files (parallel/sharded.py partial load)
    dims: dict | None = None

    def files(self) -> list[str]:
        out = [segment_file(self.name)]
        if self.del_gen >= 0:
            out.append(live_file(self.name, self.del_gen))
        if self.dv_gen >= 0:
            out.append(dvu_file(self.name, self.dv_gen))
        return out


@dataclass
class SegmentInfos:
    counter: int = 0  # next segment name number
    version: int = 0  # bumped on every commit
    generation: int = 0  # segments_N generation
    segments: list[SegmentCommitInfo] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.segments is None:
            self.segments = []

    def files(self) -> list[str]:
        out: list[str] = []
        for s in self.segments:
            out.extend(s.files())
        return out

    def clone(self) -> "SegmentInfos":
        return SegmentInfos(
            counter=self.counter,
            version=self.version,
            generation=self.generation,
            segments=[
                SegmentCommitInfo(
                    s.name, s.max_doc, s.del_gen, s.del_count, s.dv_gen, s.dims
                )
                for s in self.segments
            ],
        )


SEGMENTS_PREFIX = "segments_"
PENDING_PREFIX = "pending_segments_"


def write_segments_file(directory: Directory, infos: SegmentInfos) -> str:
    """Phase 1 of two-phase commit: write pending_segments_N
    (reference segment_infos.rs:196 prepare_commit)."""
    gen = infos.generation + 1
    pending = f"{PENDING_PREFIX}{gen}"
    out = directory.create_output(pending)
    # header carries the FINAL name: the file is renamed into place at phase 2
    out.write_header(f"{SEGMENTS_PREFIX}{gen}")
    obj = {
        "counter": infos.counter,
        "version": infos.version,
        "generation": gen,
        "segments": [
            {
                "name": s.name,
                "max_doc": s.max_doc,
                "del_gen": s.del_gen,
                "del_count": s.del_count,
                "dv_gen": s.dv_gen,
                "dims": s.dims,
            }
            for s in infos.segments
        ],
    }
    out.write(json.dumps(obj, separators=(",", ":")).encode("utf-8"))
    out.write_footer()
    out.close()
    return pending


def finish_segments_file(directory: Directory, infos: SegmentInfos, pending: str) -> str:
    """Phase 2: fsync + atomic rename pending_segments_N -> segments_N."""
    gen = infos.generation + 1
    final = f"{SEGMENTS_PREFIX}{gen}"
    directory.sync([pending])
    directory.rename(pending, final)
    infos.generation = gen
    return final


def latest_segments_gen(directory: Directory) -> int:
    gens = [
        int(n[len(SEGMENTS_PREFIX):])
        for n in directory.list_all()
        if n.startswith(SEGMENTS_PREFIX)
    ]
    return max(gens, default=-1)


def packed_dims(packed: PackedSegment) -> dict:
    """SegmentCommitInfo.dims for a packed segment: the shape + stats
    metadata a multi-host process needs about segments it does NOT load."""
    return {
        "num_blocks": int(packed.num_blocks),
        "data_words": int(len(packed.data)),
        "pos_words": int(len(packed.positions)),
        "fields": sorted(packed.fields),
        "stats": {
            f: [int(st.doc_count), int(st.sum_total_term_freq), int(st.sum_doc_freq)]
            for f, st in packed.stats.items()
        },
    }


def read_segments_file(directory: Directory) -> SegmentInfos:
    gen = latest_segments_gen(directory)
    if gen < 0:
        return SegmentInfos()
    fname = f"{SEGMENTS_PREFIX}{gen}"
    obj = json.loads(check_footer(directory.read_file(fname), fname))
    return SegmentInfos(
        counter=obj["counter"],
        version=obj["version"],
        generation=obj["generation"],
        segments=[
            SegmentCommitInfo(
                s["name"], s["max_doc"], s["del_gen"], s["del_count"],
                s.get("dv_gen", -1), s.get("dims"),
            )
            for s in obj["segments"]
        ],
    )
