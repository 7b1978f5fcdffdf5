"""Rendering tier: report artefacts, HTML and MIDI."""

from .outputs import render_all

__all__ = ["render_all"]
