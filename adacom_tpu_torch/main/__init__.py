"""Client API layer: Database, Connection, Appender, QueryResult."""
