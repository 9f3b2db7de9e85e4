"""rucene_tpu_torch — the PyTorch/CUDA port of rucene_tpu, for an NVIDIA H100.

It writes, commits, deletes, updates and merges segments (IndexWriter over
a RAMDirectory or an FSDirectory), opens a committed index written by
either package (index/reader.open_directory_reader) and serves NRT readers
(SearcherManager). It serves batches of BM25 queries built from the query
classes below:
term, boolean, phrase, range / exists / prefix filter, dismax,
constant-score, boosting, match-all, span (search/spans.py) and query-string
(parse_query_string) rows, with postings resident on the device, decoded or
packed; sorted search and field collapse (IndexSearcher.search_sorted,
search_collapse), rescoring (search/rescorer.QueryRescorer), explain and
the highlighter (highlight.FastVectorHighlighter) beside them. Rows the reference answers on its device path
run on the torch device; the rest run on the numpy host engine, as the
reference's do (search/searcher.py). The postings decoders and the dense
combine are CUDA kernels (csrc/); plain PyTorch twins serve CPU tensors.

Imports torch and numpy, never jax. Host-layer modules are copies of their
rucene_tpu counterparts (same relative path and names), held against them
by tests/test_torch_host.py.
"""

__version__ = "0.1.0"

from rucene_tpu_torch.analysis import LowercaseWhitespaceAnalyzer, WhitespaceAnalyzer
from rucene_tpu_torch.analysis.tokenizer import Token
from rucene_tpu_torch.doc import (
    Document,
    Field,
    FieldType,
    IndexOptions,
    NumericDocValuesField,
    StoredField,
    StringField,
    Term,
    TextField,
)
from rucene_tpu_torch.doc.field import (
    BinaryDocValuesField,
    FloatPoint,
    IntPoint,
    SortedDocValuesField,
    SortedNumericDocValuesField,
    SortedSetDocValuesField,
)
from rucene_tpu_torch.search.query import (
    BooleanQuery,
    BoostingQuery,
    BoostQuery,
    ConstantScoreQuery,
    DisjunctionMaxQuery,
    ExistsQuery,
    FilterQuery,
    MatchAllDocsQuery,
    Occur,
    PhraseQuery,
    PointRangeQuery,
    PrefixQuery,
    TermQuery,
)
from rucene_tpu_torch.search.query_string import parse_query_string
from rucene_tpu_torch.search.searcher import IndexSearcher, ScoreDoc, TopDocs
from rucene_tpu_torch.search.similarity import BM25Similarity
from rucene_tpu_torch.search.sort_field import Sort, SortField
from rucene_tpu_torch.index.merge import TieredMergePolicy
from rucene_tpu_torch.index.merge_scheduler import ConcurrentMergeScheduler, SerialMergeScheduler
from rucene_tpu_torch.index.reader import IndexReader, open_directory_reader
from rucene_tpu_torch.index.writer import IndexWriter, IndexWriterConfig
from rucene_tpu_torch.search.search_manager import SearcherManager
from rucene_tpu_torch.store.directory import CorruptIndexError, FSDirectory, RAMDirectory

__all__ = [
    "ConcurrentMergeScheduler",
    "CorruptIndexError",
    "FSDirectory",
    "IndexReader",
    "IndexWriter",
    "IndexWriterConfig",
    "RAMDirectory",
    "SearcherManager",
    "SerialMergeScheduler",
    "Sort",
    "SortField",
    "TieredMergePolicy",
    "open_directory_reader",
    "parse_query_string",
    "BM25Similarity",
    "BinaryDocValuesField",
    "BooleanQuery",
    "BoostQuery",
    "BoostingQuery",
    "ConstantScoreQuery",
    "DisjunctionMaxQuery",
    "Document",
    "ExistsQuery",
    "PrefixQuery",
    "Field",
    "FieldType",
    "FilterQuery",
    "FloatPoint",
    "IndexOptions",
    "IndexSearcher",
    "IntPoint",
    "LowercaseWhitespaceAnalyzer",
    "MatchAllDocsQuery",
    "NumericDocValuesField",
    "Occur",
    "PhraseQuery",
    "PointRangeQuery",
    "ScoreDoc",
    "SortedDocValuesField",
    "SortedNumericDocValuesField",
    "SortedSetDocValuesField",
    "StoredField",
    "StringField",
    "Term",
    "TermQuery",
    "TextField",
    "Token",
    "TopDocs",
    "WhitespaceAnalyzer",
]
