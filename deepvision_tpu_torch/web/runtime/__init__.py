"""Domain runtime: interview engine, report pipeline, documents, solution."""
