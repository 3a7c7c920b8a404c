"""Seed contract (`seeds`) and schema grammar (`spec`) that `sql.datagen`
and `sql.workloads` build on. Import from the modules."""
