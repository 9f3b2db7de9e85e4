"""The repo's two examples on the port (counterparts of examples/), each
runnable with ``python -m rucene_tpu_torch.examples.<name> [--device cpu]``:

- ``example``: index, commit, NRT reopen, term / boolean / phrase /
  prefix / query-string / span search and the highlighter
  (examples/example.py);
- ``nrt_search``: concurrent indexing and searching through a
  SearcherManager over the combined view, a snippet from postings
  offsets, commit and reopen (examples/nrt_search.py).

They print the reference's lines on the same documents and queries;
``stable_lines`` is what two runs must agree on.
"""

import re

_TMP = re.compile(r"\S*(rucene_tpu_example_|rtpu_nrt_)\S*")


def stable_lines(output: str) -> list[str]:
    """An example's printed lines without what differs from run to run:
    temporary paths become ``<tmp>``, and of nrt_search's ``[nrt]``
    progress lines, which follow how ingest and refreshes interleaved,
    only the last stays, without its segment count."""
    lines = [_TMP.sub("<tmp>", ln) for ln in output.splitlines()]
    nrt = [ln.split(" (")[0] for ln in lines if ln.startswith("[nrt]")]
    return [ln for ln in lines if not ln.startswith("[nrt]")] + nrt[-1:]
