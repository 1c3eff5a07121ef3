"""SQL frontend: lexer, parser, binder, optimizer, physical planning.

Parity with the reference layers 2-5 (SURVEY.md §1): Parser::ParseQuery ->
Binder/Planner -> Optimizer -> PhysicalPlanGenerator, re-implemented as a
lean hand-written frontend covering the engine's SQL surface (DDL, DML,
SELECT with joins/aggregates/ordering/CTEs, PRAGMA/SET)."""
