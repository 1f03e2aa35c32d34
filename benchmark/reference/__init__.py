"""The plain reference the benchmark holds the system's answers against."""
