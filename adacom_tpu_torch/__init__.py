"""adacom_tpu_torch — the adaptive-compression query engine on PyTorch and
CUDA, ported from the JAX package ``adacom_tpu`` (which stays the reference).

The package keeps the JAX package's layout and module names. Its first
slice is the compressed scan -> aggregate path: appender ingest, segment
compaction to frame-of-reference + vertical-lane bit-packing, SQL, and the
fused table-scan kernel (``ops/fused_scan.py``, a CUDA kernel written for
Hopper in ``csrc/table_scan.cu``), with host-tier point lookups and a host
aggregate for everything the kernel does not take.

    import adacom_tpu_torch as att
    db = att.Database(platform="cuda")   # or "cpu"
    con = db.connect()
    con.query("CREATE TABLE t(i UINTEGER)")
    app = con.appender("t")
    app.append_column("i", values)       # bulk columnar ingest
    app.close()
    con.query("SELECT count(*), sum(i) FROM t").fetchall()

Importing the package loads neither ``jax`` nor ``adacom_tpu``.
"""

from adacom_tpu_torch.config import DBConfig

__version__ = "0.1.0"

__all__ = ["Database", "Connection", "DBConfig", "__version__"]


def __getattr__(name):
    # lazy imports keep `import adacom_tpu_torch` light and free of cycles
    if name == "Database":
        from adacom_tpu_torch.main.database import Database

        return Database
    if name == "Connection":
        from adacom_tpu_torch.main.connection import Connection

        return Connection
    raise AttributeError(name)
