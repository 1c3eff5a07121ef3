"""adacom_tpu_torch — the adaptive-compression query engine on PyTorch and
CUDA, ported from the JAX package ``adacom_tpu`` (which stays the reference).

The package keeps the JAX package's layout and module names. It carries
the compressed scan -> aggregate path: appender ingest, segment compaction
(frame-of-reference + vertical-lane bit-packing, or a generic codec), SQL,
the fused scan kernels written for Hopper (``csrc/*.cu``), the generic
device path in PyTorch ops for what they decline (``exec/device_scan.py``),
DELETE/UPDATE, host-tier point lookups and a host aggregate.

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
