"""Execution paths over the fused graph (single track for now)."""
