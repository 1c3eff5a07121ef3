"""Statement verification: logical self-checking of query results (port
of adacom_tpu/main/verification.py).

Parity with the reference's StatementVerifier family
(src/verification/statement_verifier.hpp:17-29 — copied / parsed /
unoptimized / deserialized / prepared variants re-executed and compared in
PendingStatementOrPreparedStatementInternal, client_context.cpp:643+).

Variants here:
- ``copied``       — fresh bind + full optimize from the same AST (catches
                     plan-cache poisoning and binder state mutation);
- ``unoptimized``  — fresh bind + only the *required* rewrites (subquery
                     decorrelation lives in push_filters, like the reference
                     keeps binder-level rewrites) with TopN fusion and column
                     pruning skipped (catches optimizer wrong-results bugs);
- ``deserialized`` — the optimized plan serialized to JSON text and
                     reconstructed through sql/serialize.py, then executed
                     (catches serializer gaps and hidden in-memory state
                     the plan silently depends on — the reference's
                     deserialized_statement_verifier.cpp);
- ``prepared``     — the plan as a value-free template (parameter slots
                     only), literal values supplied at execution — the
                     prepared-statement path (prepared_statement_verifier.cpp);
                     statements whose binding baked literal values
                     (bind-time-evaluated functions, binder.structural
                     non-empty) are skipped, as the reference skips
                     unpreparable statements;
- ``parsed``       — the ORIGINAL SQL text re-lexed and re-parsed, then
                     bound and executed (parsed_statement_verifier.cpp);
                     also cross-checks that literal extraction reproduces
                     the same parameter list;
- ``external``     — executed on a FRESH Connection of the same database
                     (new executor, empty caches): catches connection-local
                     state leaking into results (external_statement_verifier.cpp).

Enabled via ``SET query_verification_enabled = true`` (the reference enables
it in debug builds / tests). Results are compared as row multisets; LIMIT
without ORDER BY is skipped (any row subset is a correct answer).
"""

from __future__ import annotations

from typing import List, Optional

from adacom_tpu_torch.sql import ast
from adacom_tpu_torch.sql import bound as b
from adacom_tpu_torch.sql.binder import Binder
from adacom_tpu_torch.sql.optimizer import optimize, push_filters


class VerificationError(Exception):
    pass


def _rows_key(result_rows: List[tuple]) -> List[str]:
    return sorted(repr(r) for r in result_rows)


def _has_unordered_limit(plan: b.LogicalOp) -> bool:
    for node in b.walk(plan):
        if isinstance(node, (b.LogicalLimit, b.LogicalTopN)):
            return True
    return False


def verify_select(connection, stmt: ast.SelectStmt, lits,
                  baseline_rows: List[tuple], sql=None,
                  stmt_idx: int = 0) -> Optional[str]:
    """Re-run `stmt` through verification variants and compare with the
    baseline rows. Returns None on success, raises VerificationError on a
    mismatch. Skips nondeterministic shapes (LIMIT without total order)."""
    from adacom_tpu_torch.main.result import QueryResult

    base = _rows_key(baseline_rows)
    variants = ["copied", "parsed", "unoptimized", "deserialized",
                "prepared", "external"]
    for variant in variants:
        executor = connection.executor
        binder = Binder(connection.db.catalog, connection.db.config)
        use_stmt = stmt
        if variant == "parsed":
            # re-lex + re-parse the ORIGINAL SQL text (the reference's
            # parsed_statement_verifier.cpp: statement->ToString() round
            # trip; here the raw text IS available)
            if sql is None:
                continue
            from adacom_tpu_torch.sql.parser import parse as _parse

            try:
                stmts2, _k, lits2, _s = _parse(sql)
                use_stmt = stmts2[stmt_idx]
            except Exception as e:
                raise VerificationError(
                    f"verifier [parsed]: re-parse failed: {e}")
            if repr(lits2) != repr(list(lits)):
                raise VerificationError(
                    "verifier [parsed]: literal extraction diverged")
        plan = binder.bind_select(use_stmt)
        if variant == "prepared" and binder.structural:
            # the binder baked literal values into this plan (bind-time-
            # evaluated functions): not preparable as a value-free
            # template — skip, as the reference's prepared verifier skips
            # unpreparable statements
            continue
        if _has_unordered_limit(plan):
            return None
        if variant == "external":
            # fresh connection = fresh executor + caches on the same db
            executor = type(connection)(connection.db).executor
        if variant == "unoptimized":
            plan = push_filters(plan)  # required rewrites only
        else:
            plan = optimize(plan, set(binder.structural))
        if variant == "deserialized":
            import json

            from adacom_tpu_torch.sql.serialize import (deserialize_plan,
                                                  serialize_plan)

            try:
                payload = json.dumps(
                    serialize_plan(plan, connection.db.catalog))
            except Exception as e:
                raise VerificationError(
                    f"verifier [deserialized]: serialization failed: {e}")
            plan = deserialize_plan(json.loads(payload),
                                    connection.db.catalog)
        mat = executor.execute(plan, lits)
        rows = QueryResult(mat.names, mat.types, mat.cols, mat.valids,
                           mat.dicts).fetchall()
        got = _rows_key(rows)
        if got != base:
            raise VerificationError(
                f"verifier [{variant}]: result mismatch "
                f"({len(got)} vs {len(base)} rows; "
                f"first diff: {_first_diff(got, base)})")
    return None


def _first_diff(a: List[str], b_: List[str]) -> str:
    for x, y in zip(a, b_):
        if x != y:
            return f"{x} != {y}"
    return "row-count mismatch"
