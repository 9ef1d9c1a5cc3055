"""Test-only helpers (reference differential harness)."""
