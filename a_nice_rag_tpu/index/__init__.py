"""Device-resident array index: the framework's storage layer.

Replaces the reference's L1/L2 layers (SQLite chunk DBs decoded row-by-row
into pandas DataFrames + pickled rank_bm25 index; ``src/database_manager.py``)
with one columnar artifact uploaded to device memory once:

* per-embedding-model dense matrix ``[N_pad, D]`` (unit-norm),
* CSR "eager impact" BM25 postings (:class:`~a_nice_rag_tpu.ops.bm25.Bm25Arrays`),
* host-side metadata tables (ids, sources, contents, urls) and cached
  filename-type filter masks.
"""

from a_nice_rag_tpu.index.array_index import (  # noqa: F401
    ArrayIndex,
    CorpusMeta,
    build_index,
    build_bm25_arrays,
)
from a_nice_rag_tpu.index.io import (  # noqa: F401
    save_index,
    load_index,
    load_reference_chunk_db,
    load_reference_query_db,
)
from a_nice_rag_tpu.index.updates import (  # noqa: F401
    append_documents,
    delete_documents,
    undelete_documents,
)
from a_nice_rag_tpu.index.ivf import (  # noqa: F401
    IVFDense,
    attach_ivf,
    build_ivf_dense,
    build_ivf_quantized,
    ivf_search,
    load_ivf,
    save_ivf,
)
