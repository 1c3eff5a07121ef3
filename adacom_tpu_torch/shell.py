"""Interactive SQL shell (reference tools/shell/shell.c + linenoise; port of
adacom_tpu/shell.py).

Run as ``python3 -m adacom_tpu_torch [--platform cuda|cpu] [db-directory]
[SQL ...]``; the platform is the database's torch device, cuda by default.
SQL given as arguments or piped on stdin runs in csv mode. Dot-commands
follow the reference shell:

    .tables            list tables and views
    .schema [table]    show CREATE-style schemas
    .indexes           list indexes
    .timer on|off      per-query wall time
    .mode box|csv      output format
    .read FILE         execute SQL from a file
    .open [PATH]       reopen (optionally durable at PATH)
    .compact           compact all segments now
    .stats             per-segment compression report
    .help / .quit
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import torch

import adacom_tpu_torch as att
from adacom_tpu_torch.main.connection import SQLError


def _fmt_box(names: List[str], rows: List[tuple], max_rows: int = 40) -> str:
    shown = rows[:max_rows]
    cells = [[str(n) for n in names]] + [
        ["" if v is None else str(v) for v in r] for r in shown]
    widths = [max(len(row[i]) for row in cells) for i in range(len(names))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    for k, row in enumerate(cells):
        out.append("| " + " | ".join(c.ljust(w) for c, w in zip(row, widths))
                   + " |")
        if k == 0:
            out.append(sep)
    out.append(sep)
    if len(rows) > max_rows:
        out.append(f"({len(rows)} rows, showing first {max_rows})")
    else:
        out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


def _fmt_csv(names: List[str], rows: List[tuple]) -> str:
    lines = [",".join(names)]
    for r in rows:
        lines.append(",".join("" if v is None else str(v) for v in r))
    return "\n".join(lines)


class Shell:
    def __init__(self, path: Optional[str] = None,
                 platform: Optional[str] = None):
        self.platform = platform
        self.db = att.Database(path=path, platform=platform)
        self.con = self.db.connect()
        self.timer = False
        self.mode = "box"

    # ------------------------------------------------------------------
    def run_sql(self, sql: str) -> None:
        t0 = time.perf_counter()
        try:
            res = self.con.query(sql)
        except SQLError as e:
            print(f"Error: {e}")
            return
        if res is not None:
            rows = res.fetchall()
            fmt = _fmt_csv if self.mode == "csv" else _fmt_box
            print(fmt(res.names, rows))
        if self.timer:
            print(f"Run Time: {time.perf_counter() - t0:.3f}s")

    def dot_command(self, line: str) -> bool:
        """Returns False to exit the shell."""
        parts = line.split()
        cmd, args = parts[0], parts[1:]
        if cmd in (".quit", ".exit", ".q"):
            return False
        if cmd == ".tables":
            for t in sorted(self.db.catalog.tables):
                print(t)
            for v in sorted(self.db.catalog.views):
                print(f"{v} (view)")
        elif cmd == ".schema":
            items = ([args[0].lower()] if args
                     else sorted(self.db.catalog.tables))
            for name in items:
                t = self.db.catalog.tables.get(name)
                if t is None:
                    print(f"-- no such table: {name}")
                    continue
                cols = ", ".join(f"{c} {t.columns[c].ltype}"
                                 for c in t.column_order)
                print(f"CREATE TABLE {name}({cols});")
        elif cmd == ".indexes":
            for idx in self.db.catalog.indexes.values():
                u = "UNIQUE " if idx.unique else ""
                print(f"CREATE {u}INDEX {idx.name} ON "
                      f"{idx.table.name}({idx.column});")
        elif cmd == ".timer":
            self.timer = bool(args) and args[0].lower() == "on"
            print(f"timer {'on' if self.timer else 'off'}")
        elif cmd == ".mode":
            if args and args[0] in ("box", "csv"):
                self.mode = args[0]
            print(f"mode {self.mode}")
        elif cmd == ".read":
            if not args:
                print("usage: .read FILE")
            else:
                try:
                    with open(args[0]) as f:
                        self.run_sql(f.read())
                except OSError as e:
                    print(f"Error: {e}")
        elif cmd == ".open":
            self.db.close()
            self.db = att.Database(path=args[0] if args else None,
                                   platform=self.platform)
            self.con = self.db.connect()
        elif cmd == ".compact":
            self.db.catalog.get_column_segment_catalog().compact_all_segments()
            print("compacted")
        elif cmd == ".stats":
            self.run_sql("PRAGMA compression_info")
        elif cmd == ".help":
            print(__doc__)
        else:
            print(f"unknown command {cmd} (try .help)")
        return True

    # ------------------------------------------------------------------
    def repl(self) -> None:
        dev = self.db.device
        card = (f" ({torch.cuda.get_device_name(dev)})"
                if dev.type == "cuda" else "")
        print(f"adacom_tpu_torch shell — torch device: {dev}{card}")
        print('Enter SQL terminated by ";", or dot-commands (.help).')
        buf: List[str] = []
        while True:
            try:
                prompt = "adacom> " if not buf else "   ...> "
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not buf and line.strip().startswith("."):
                if not self.dot_command(line.strip()):
                    break
                continue
            buf.append(line)
            joined = "\n".join(buf)
            if joined.rstrip().endswith(";"):
                self.run_sql(joined)
                buf = []
        self.db.close()


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = platform = None
    sql_args: List[str] = []
    args = iter(argv)
    for a in args:
        if a in ("-h", "--help"):
            print(__doc__)
            return 0
        if a in ("-c", "--command"):
            continue
        if a == "--platform" or a.startswith("--platform="):
            platform = a.split("=", 1)[1] if "=" in a else next(args, None)
            if platform not in ("cuda", "cpu"):
                print(f"--platform takes cuda or cpu, not {platform!r}")
                return 2
            continue
        if a.startswith("-"):
            print(f"unknown option {a}")
            return 2
        if path is None and not a.strip().upper().startswith(
                ("SELECT", "CREATE", "INSERT", "COPY", "PRAGMA", "EXPLAIN",
                 "WITH", "SET", "DROP", "DELETE", "UPDATE", "DESCRIBE")):
            path = a
        else:
            sql_args.append(a)
    sh = Shell(path, platform)
    if sql_args:
        for sql in sql_args:
            sh.mode = "csv"
            sh.run_sql(sql)
        sh.db.close()
        return 0
    if not sys.stdin.isatty():
        sh.mode = "csv"
        sh.run_sql(sys.stdin.read())
        sh.db.close()
        return 0
    sh.repl()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
