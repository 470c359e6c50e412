"""Device timing helpers."""
