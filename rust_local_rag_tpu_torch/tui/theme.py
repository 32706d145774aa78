"""Color themes (cf. bin/rag_tui/theme.rs — three palettes); a copy of
rust_local_rag_tpu/tui/theme.py."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Theme:
    name: str
    # curses color constants are resolved in ui.py; here: logical colors
    accent: str
    highlight: str
    dim: str
    error: str
    ok: str


THEMES = {
    "default": Theme("default", "cyan", "yellow", "white", "red", "green"),
    "dark": Theme("dark", "blue", "magenta", "white", "red", "green"),
    "light": Theme("light", "black", "blue", "black", "red", "green"),
}


def next_theme(current: str) -> str:
    names = list(THEMES)
    return names[(names.index(current) + 1) % len(names)] if current in names else "default"


def get_theme(name: str) -> Theme:
    return THEMES.get(name, THEMES["default"])
