"""CheckIndex: offline index integrity verification.

The reference never ported Lucene's CheckIndex (SURVEY.md §4 notes the
gap); this fills it. Verifies, per committed segment:
- file framing + CRC32 of every referenced file (codec_util semantics);
- postings invariants: strictly increasing doc ids in range, freqs >= 1,
  doc_freq / total_tf metadata consistent with the streams, positions
  non-decreasing per doc;
- norms/doc-values/live array lengths vs max_doc;
- segments_N references only existing files.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from rucene_tpu_torch.codec import files as segfiles
from rucene_tpu_torch.index.reader import SegmentSnapshot
from rucene_tpu_torch.store.directory import CorruptIndexError, Directory


@dataclass
class SegmentStatus:
    name: str
    max_doc: int = 0
    num_terms: int = 0
    num_postings: int = 0
    errors: list[str] = dc_field(default_factory=list)


@dataclass
class CheckIndexStatus:
    clean: bool = True
    generation: int = -1
    segments: list[SegmentStatus] = dc_field(default_factory=list)
    errors: list[str] = dc_field(default_factory=list)

    def render(self) -> str:
        out = [f"segments_N generation: {self.generation}  clean: {self.clean}"]
        for s in self.segments:
            state = "OK" if not s.errors else f"BROKEN ({len(s.errors)} errors)"
            out.append(
                f"  segment {s.name}: {s.max_doc} docs, {s.num_terms} terms, "
                f"{s.num_postings} postings — {state}"
            )
            out.extend(f"    ! {e}" for e in s.errors)
        out.extend(f"! {e}" for e in self.errors)
        return "\n".join(out)


def check_index(directory: Directory, sample_terms_per_field: int | None = None) -> CheckIndexStatus:
    status = CheckIndexStatus()
    try:
        infos = segfiles.read_segments_file(directory)
    except CorruptIndexError as e:
        status.clean = False
        status.errors.append(f"segments file corrupt: {e}")
        return status
    status.generation = infos.generation

    existing = set(directory.list_all())
    for fname in infos.files():
        if fname not in existing:
            status.clean = False
            status.errors.append(f"missing file: {fname}")

    for info in infos.segments:
        seg = SegmentStatus(name=info.name)
        status.segments.append(seg)
        try:
            # CheckIndex is where whole-file CRC verification lives now
            # that serving opens are lazy/mmap (no CRC pass on open)
            packed = segfiles.read_segment(directory, info.name, lazy=False)
        except Exception as e:  # CRC/framing/parse failures
            seg.errors.append(f"segment unreadable: {e}")
            status.clean = False
            continue
        seg.max_doc = packed.max_doc
        if info.max_doc != packed.max_doc:
            seg.errors.append(
                f"max_doc mismatch: commit {info.max_doc} vs segment {packed.max_doc}"
            )

        live = None
        if info.del_gen >= 0:
            try:
                live = segfiles.read_live(directory, info.name, info.del_gen)
                if len(live) != packed.max_doc:
                    seg.errors.append("live-docs length != max_doc")
                if int((~live).sum()) != info.del_count:
                    seg.errors.append("del_count mismatch with live mask")
            except Exception as e:
                seg.errors.append(f"live file unreadable: {e}")

        snap = SegmentSnapshot(info.name, packed, live=live)
        for fname_, pf in packed.fields.items():
            seg.num_terms += len(pf.terms)
            terms = pf.terms
            if sample_terms_per_field is not None and len(terms) > sample_terms_per_field:
                idx = np.linspace(0, len(terms) - 1, sample_terms_per_field).astype(int)
                terms = [terms[i] for i in idx]
            prev_term = None
            for t in terms:
                if prev_term is not None and not (prev_term < t) and sample_terms_per_field is None:
                    seg.errors.append(f"terms out of order in field {fname_!r}: {prev_term!r} >= {t!r}")
                prev_term = t
                try:
                    docs, freqs, pos = snap.read_postings(fname_, t, with_positions=True)
                except Exception as e:
                    seg.errors.append(f"postings unreadable for {fname_}:{t}: {e}")
                    continue
                seg.num_postings += len(docs)
                ord_ = pf.term_ord[t]
                if len(docs) != int(pf.doc_freq[ord_]):
                    seg.errors.append(f"doc_freq mismatch for {fname_}:{t}")
                if int(freqs.sum()) != int(pf.total_tf[ord_]):
                    seg.errors.append(f"total_tf mismatch for {fname_}:{t}")
                if len(docs) and (
                    docs[0] < 0
                    or docs[-1] >= packed.max_doc
                    or np.any(np.diff(docs) <= 0)
                ):
                    seg.errors.append(f"doc ids not strictly increasing/in range for {fname_}:{t}")
                if np.any(freqs < 1):
                    seg.errors.append(f"zero freq in {fname_}:{t}")
                # positions: per-doc runs must be non-decreasing
                if len(pos):
                    run = np.concatenate([[0], np.cumsum(freqs)])
                    for i in range(len(docs)):
                        p = pos[run[i] : run[i + 1]]
                        if len(p) > 1 and np.any(np.diff(p) < 0):
                            seg.errors.append(f"positions decrease in {fname_}:{t} doc {docs[i]}")
                            break

        for f, arr in packed.norms.items():
            if len(arr) != packed.max_doc:
                seg.errors.append(f"norms length mismatch for field {f!r}")
        for f, (vals, present) in packed.numeric_dv.items():
            if len(vals) != packed.max_doc or len(present) != packed.max_doc:
                seg.errors.append(f"numeric DV length mismatch for field {f!r}")
        if len(packed.stored) != packed.max_doc:
            seg.errors.append("stored-fields count != max_doc")
        if seg.errors:
            status.clean = False
    return status


def exorcise(directory: Directory) -> list[str]:
    """Repair mode (Lucene CheckIndex -exorcise): drop every segment with
    detectable problems (unreadable, failed invariants, or missing files)
    from the commit and write a new segments_N. THE DROPPED SEGMENTS' DOCS
    ARE LOST — this is a last-resort tool for an index that won't open.
    Returns the dropped segment names."""
    status = check_index(directory)
    if status.clean:
        return []
    try:
        infos = segfiles.read_segments_file(directory)
    except CorruptIndexError:
        return []  # the commit point itself is corrupt; nothing to salvage
        # segment-wise (restore an older segments_N generation by hand)
    existing = set(directory.list_all())
    broken_by_check = {s.name for s in status.segments if s.errors}
    dropped: list[str] = []
    kept = []
    for info in infos.segments:
        missing = [f for f in info.files() if f not in existing]
        if info.name in broken_by_check or missing:
            dropped.append(info.name)
        else:
            kept.append(info)
    if not dropped:
        return []  # corruption not attributable to one segment (e.g. the
        # segments file itself) — nothing safe to drop
    infos.segments = kept
    infos.version += 1
    pending = segfiles.write_segments_file(directory, infos)
    segfiles.finish_segments_file(directory, infos, pending)
    # GC files of the dropped segments (best effort)
    still_referenced = set(infos.files())
    for name in dropped:
        for f in list(existing):
            if f.startswith(f"{name}.") or f.startswith(f"{name}_"):
                if f not in still_referenced:
                    try:
                        directory.delete_file(f)
                    except OSError:
                        pass
    return dropped


def main(argv=None) -> int:
    """CLI: python -m rucene_tpu_torch.tools.check_index [-exorcise] <index_dir>"""
    import sys

    from rucene_tpu_torch.store.directory import FSDirectory

    args = list(argv if argv is not None else sys.argv[1:])
    do_exorcise = "-exorcise" in args
    if do_exorcise:
        args.remove("-exorcise")
    if len(args) != 1:
        print(
            "usage: python -m rucene_tpu_torch.tools.check_index [-exorcise] <index_dir>",
            file=sys.stderr,
        )
        return 2
    d = FSDirectory(args[0])
    status = check_index(d)
    print(status.render())
    if status.clean:
        return 0
    if do_exorcise:
        dropped = exorcise(d)
        if dropped:
            print(f"exorcised {len(dropped)} broken segment(s): {', '.join(dropped)}")
            after = check_index(d)
            print(after.render())
            return 0 if after.clean else 1
        print("nothing exorcisable (commit-level corruption)")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
