"""Index sorting: reorder a flushed segment by a Sort before packing.

reference: rucene src/core/codec/sorter.rs:657-file (doc-map builders) and
index/reader/leaf_reader_wrapper.rs (SortingLeafReader :275) — there the
permutation is applied by wrapping every codec stream; here it is a single
columnar remap of SegmentData before pack_segment, after which searches can
early-terminate per segment (collector/early_terminating.rs:17 analog).
"""

from __future__ import annotations

import numpy as np

from rucene_tpu_torch.index.memory import SegmentData
from rucene_tpu_torch.search.sort_field import Sort, SortFieldType


def sort_permutation(seg: SegmentData, sort: Sort) -> np.ndarray | None:
    """old-doc-order array such that new doc i = old doc perm[i]; None if
    the segment is already in order."""
    md = seg.max_doc
    keys: list[np.ndarray] = [np.arange(md)]  # final tie-break: old doc id
    for sf in reversed(sort.fields):
        if sf.type in (SortFieldType.SCORE,):
            raise ValueError("cannot sort an index by SCORE")
        if sf.type == SortFieldType.DOC:
            col = np.arange(md, dtype=np.int64)
        else:
            dv = seg.numeric_dv.get(sf.field)
            if dv is None:
                col = np.zeros(md, dtype=np.int64)
            else:
                col = np.where(dv[1], dv[0], 0)
        keys.append(-col if sf.reverse else col)
    perm = np.lexsort(tuple(keys))
    if np.array_equal(perm, np.arange(md)):
        return None
    return perm


def sort_segment_data(seg: SegmentData, sort: Sort) -> SegmentData:
    """Apply the sort permutation to every column of the segment."""
    perm = sort_permutation(seg, sort)
    if perm is None:
        return seg
    md = seg.max_doc
    new_of_old = np.empty(md, dtype=np.int64)
    new_of_old[perm] = np.arange(md)

    terms_out = {}
    for field, tmap in seg.terms.items():
        fout = {}
        for term, (docs, freqs, pos) in tmap.items():
            nd = new_of_old[docs]
            order = np.argsort(nd, kind="stable")
            run_starts = np.concatenate([[0], np.cumsum(freqs)])[:-1]
            pos_parts = [pos[run_starts[i] : run_starts[i] + freqs[i]] for i in order]
            fout[term] = (
                nd[order].astype(np.int32),
                freqs[order].astype(np.int32),
                (np.concatenate(pos_parts) if pos_parts else np.zeros(0)).astype(np.int32),
            )
        terms_out[field] = fout

    norms_out = {f: arr[perm] for f, arr in seg.norms.items()}
    stored_out = [seg.stored[int(o)] for o in perm]
    dv_out = {f: (v[perm], p[perm]) for f, (v, p) in seg.numeric_dv.items()}
    points_out = {}
    for f, (vals, docs) in seg.points.items():
        nd = new_of_old[docs]
        order = np.lexsort((nd, vals))
        points_out[f] = (vals[order], nd[order].astype(np.int32))
    tv_out = None
    if seg.term_vectors is not None:
        tv_out = [seg.term_vectors[int(o)] for o in perm]

    return SegmentData(
        max_doc=md,
        field_infos=seg.field_infos,
        terms=terms_out,
        norms=norms_out,
        stats=seg.stats,
        stored=stored_out,
        numeric_dv=dv_out,
        points=points_out,
        term_vectors=tv_out,
    )
