"""Debug and observability utilities (`diagnostics`)."""
