"""`python -m strique_tpu_torch` == the port's strique CLI."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
