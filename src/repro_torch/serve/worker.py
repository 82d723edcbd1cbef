"""A fleet worker's process entry.

    python -m repro_torch.serve.worker --worker --name W --in-fd R \
        --out-fd W [--hb S] [--device cpu]

runs ``transport.worker_main``.  ``ProcWorker`` starts its children
this way: ``transport`` is imported here under its own name, never run
as ``__main__``, so its message classes pickle as
``repro_torch.serve.transport.*`` and the package may import it first.
"""
import sys

from repro_torch.serve.transport import worker_main

if __name__ == "__main__":
    sys.exit(worker_main())
