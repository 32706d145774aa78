"""`python -m rust_local_rag_tpu_torch.tui` — start the terminal client."""

import sys

from rust_local_rag_tpu_torch.tui.main import main

if __name__ == "__main__":
    sys.exit(main())
