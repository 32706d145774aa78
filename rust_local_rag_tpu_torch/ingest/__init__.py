"""Host-side ingest: PDF text extraction and sentence-aware chunking."""

from rust_local_rag_tpu_torch.ingest.chunking import (  # noqa: F401
    ChunkFragment,
    chunk_text,
)
from rust_local_rag_tpu_torch.ingest.pdf import extract_pdf_text  # noqa: F401
