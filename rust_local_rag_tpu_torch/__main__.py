"""`python -m rust_local_rag_tpu_torch`: start the port's RAG server (HTTP
+ MCP on MCP_HTTP_BIND, on the card; RAG_TPU_PLATFORM=cpu for the CPU)."""

import sys

from rust_local_rag_tpu_torch.server.app import main

if __name__ == "__main__":
    sys.exit(main())
