"""curses rendering (cf. bin/rag_tui/ui.rs draw functions; port of
rust_local_rag_tpu/tui/ui.py). draw() needs only the surface of curses'
stdscr that it calls: erase, getmaxyx, addnstr, move and refresh."""

from __future__ import annotations

import curses
from typing import List

from rust_local_rag_tpu_torch.tui.app import AppState, Mode
from rust_local_rag_tpu_torch.tui.settings import Settings, validate
from rust_local_rag_tpu_torch.tui.theme import Theme

_COLOR_IDS = {
    "cyan": curses.COLOR_CYAN,
    "yellow": curses.COLOR_YELLOW,
    "white": curses.COLOR_WHITE,
    "red": curses.COLOR_RED,
    "green": curses.COLOR_GREEN,
    "blue": curses.COLOR_BLUE,
    "magenta": curses.COLOR_MAGENTA,
    "black": curses.COLOR_WHITE,  # avoid invisible text on dark terminals
}

_PAIRS: dict = {}


def init_colors() -> None:
    if not curses.has_colors():
        return
    curses.start_color()
    curses.use_default_colors()
    for i, name in enumerate(
        ["cyan", "yellow", "white", "red", "green", "blue", "magenta", "black"],
        start=1,
    ):
        curses.init_pair(i, _COLOR_IDS[name], -1)
        _PAIRS[name] = curses.color_pair(i)


def _attr(color: str, bold: bool = False) -> int:
    a = _PAIRS.get(color, 0)
    return a | (curses.A_BOLD if bold else 0)


def _safe_add(win, y: int, x: int, text: str, attr: int = 0) -> None:
    h, w = win.getmaxyx()
    if 0 <= y < h and x < w:
        try:
            win.addnstr(y, x, text, max(0, w - x - 1), attr)
        except curses.error:
            pass


def _wrap(text: str, width: int) -> List[str]:
    out: List[str] = []
    for para in text.split("\n"):
        line = ""
        for word in para.split(" "):
            if len(line) + len(word) + 1 > width and line:
                out.append(line)
                line = word
            else:
                line = (line + " " + word).strip()
        out.append(line)
    return out


def draw(stdscr, state: AppState, settings: Settings, theme: Theme) -> None:
    stdscr.erase()
    h, w = stdscr.getmaxyx()

    _draw_header(stdscr, state, theme, w)
    if state.mode == Mode.HELP:
        _draw_help(stdscr, theme, h, w)
    elif state.mode == Mode.SETTINGS:
        _draw_settings(stdscr, state, settings, theme, h, w)
    elif state.mode == Mode.DETAIL:
        _draw_detail(stdscr, state, theme, h, w)
    else:
        _draw_results(stdscr, state, theme, h, w)
    _draw_status(stdscr, state, theme, h, w)

    # cursor in the search bar
    if state.mode == Mode.NORMAL:
        try:
            stdscr.move(1, min(w - 2, 10 + state.cursor))
        except curses.error:
            pass
    stdscr.refresh()


def _draw_header(stdscr, state: AppState, theme: Theme, w: int) -> None:
    title = " rag-tui — TPU local RAG "
    _safe_add(stdscr, 0, 1, title, _attr(theme.accent, bold=True))
    health = "●" if state.healthy else "○"
    hcolor = theme.ok if state.healthy else theme.error
    _safe_add(stdscr, 0, max(0, w - 3), health, _attr(hcolor, bold=True))
    prompt = "Search ▸ "
    _safe_add(stdscr, 1, 1, prompt, _attr(theme.dim))
    _safe_add(stdscr, 1, 10, state.query, _attr(theme.highlight, bold=True))
    if state.searching:
        _safe_add(stdscr, 1, max(0, w - 12), "searching…", _attr(theme.dim))


def _draw_results(stdscr, state: AppState, theme: Theme, h: int, w: int) -> None:
    top = 3
    visible = h - top - 2
    if not state.results:
        hint = (
            "Type to search. Enter: detail  Ctrl-R: reindex  F1: help  "
            "F2: settings  Esc: quit"
        )
        _safe_add(stdscr, top + 1, 3, hint, _attr(theme.dim))
        return
    first = max(0, state.selected - visible + 1)
    for row, idx in enumerate(range(first, min(len(state.results), first + visible))):
        r = state.results[idx]
        y = top + row
        sel = idx == state.selected
        marker = "▶" if sel else " "
        pct = round(r.score * 100)
        prov = f"{r.document} p{r.page_number}" if r.page_number else r.document
        line = f"{marker} [{pct:3d}%] {prov}: {r.text[: max(0, w - 30)]}"
        _safe_add(
            stdscr, y, 1, line,
            _attr(theme.highlight, bold=True) if sel else _attr(theme.dim),
        )


def _draw_detail(stdscr, state: AppState, theme: Theme, h: int, w: int) -> None:
    r = state.selected_result()
    if r is None:
        return
    top = 3
    _safe_add(stdscr, top, 1, f"{r.document}  (page {r.page_number})",
              _attr(theme.accent, bold=True))
    if r.section:
        _safe_add(stdscr, top + 1, 1, f"Section: {r.section}", _attr(theme.dim))

    # score breakdown (the reference TUI's detail pane)
    parts = [f"final {r.score:.4f}"]
    if r.embedding_score is not None:
        parts.append(f"embed {r.embedding_score:.4f}")
    if r.lexical_score is not None:
        parts.append(f"lex {r.lexical_score:.4f}")
    if r.initial_score is not None:
        parts.append(f"initial {r.initial_score:.4f}")
    if r.reranker_score is not None:
        parts.append(f"rerank {r.reranker_score:.4f}")
    if r.yes_logprob is not None:
        parts.append(f"yes_lp {r.yes_logprob:.3f}")
    if r.no_logprob is not None:
        parts.append(f"no_lp {r.no_logprob:.3f}")
    _safe_add(stdscr, top + 2, 1, " | ".join(parts), _attr(theme.ok))

    lines = _wrap(r.text, w - 4)
    area = h - top - 6
    for i, line in enumerate(lines[state.detail_scroll : state.detail_scroll + area]):
        _safe_add(stdscr, top + 4 + i, 2, line, 0)
    _safe_add(stdscr, h - 2, 1, "Up/Down scroll · Esc back", _attr(theme.dim))


def _draw_help(stdscr, theme: Theme, h: int, w: int) -> None:
    lines = [
        "Keys",
        "",
        "  type          search as you type (debounced)",
        "  Up / Down     select result / scroll detail",
        "  Enter         open result detail",
        "  Ctrl-R        start background reindex",
        "  Ctrl-T        cycle theme",
        "  Ctrl-U        clear query",
        "  Ctrl-Y        copy selected result text (OSC52)",
        "  F1 or ?       toggle this help",
        "  F2            settings editor (.env)",
        "  Esc           back / quit",
    ]
    for i, line in enumerate(lines):
        _safe_add(stdscr, 3 + i, 3, line, _attr(theme.accent if i == 0 else theme.dim))


def _draw_settings(
    stdscr, state: AppState, settings: Settings, theme: Theme, h: int, w: int
) -> None:
    _safe_add(stdscr, 3, 1, "Settings (.env)", _attr(theme.accent, bold=True))
    for i, (key, desc, value) in enumerate(settings.rows()):
        y = 5 + i
        sel = i == state.settings_selected
        # one validation a row a frame (path keys stat the filesystem), so a
        # directory created while the editor is open shows as valid
        verdict = validate(key, value) if value else None
        marker = "▶" if sel else " "
        name_attr = _attr(theme.highlight, bold=True) if sel else _attr(theme.dim)
        _safe_add(stdscr, y, 1, f"{marker} {key:28s} ", name_attr)
        vx = 1 + len(f"{marker} {key:28s} ")
        if sel and state.settings_editing:
            # edit buffer with a block cursor at settings_cursor
            # (reference renders before/at/after spans, ui.rs:576-610)
            buf, cur = state.settings_edit_buffer, state.settings_cursor
            _safe_add(stdscr, y, vx, buf[:cur], _attr(theme.highlight, bold=True))
            at = buf[cur] if cur < len(buf) else " "
            _safe_add(stdscr, y, vx + cur, at, curses.A_REVERSE)
            _safe_add(
                stdscr, y, vx + cur + 1, buf[cur + 1 :],
                _attr(theme.highlight, bold=True),
            )
        else:
            # validation-aware value coloring + modified / restart markers
            # (ui.rs:612-667)
            modified = settings.is_modified(key)
            if verdict is not None and verdict[0] == "error":
                vattr, indicator = _attr(theme.error, bold=sel), " ✗"
            elif verdict is not None:
                vattr, indicator = _attr("yellow", bold=sel), " ⚠"
            else:
                vattr = _attr("yellow" if modified else theme.ok, bold=sel)
                indicator = ""
            tail = indicator + (" *" if modified else "")
            if modified and settings.requires_restart(key):
                tail += " (restart)"
            _safe_add(stdscr, y, vx, (value or "(unset)") + tail, vattr)
        if sel:
            line = desc
            if verdict is not None:
                mark = "✗" if verdict[0] == "error" else "⚠"
                line += f"   {mark} {verdict[1]}"
            _safe_add(stdscr, h - 3, 1, line, _attr(theme.dim))
    _safe_add(
        stdscr, h - 2, 1,
        "Enter edit/apply · ←/→ cycle choices · Ctrl-S save .env · Esc back",
        _attr(theme.dim),
    )


def _draw_status(stdscr, state: AppState, theme: Theme, h: int, w: int) -> None:
    left = state.status_line
    if state.reindexing and state.job:
        left = (
            f"reindexing {state.job.progress}/{state.job.total} "
            f"({state.job.job_id[:8]})"
        )
    right = ""
    if state.stats:
        right = (
            f"{state.stats.documents} docs · {state.stats.chunks} chunks · "
            f"{state.stats.status} · {state.stats.embedding_model}"
        )
        if state.stats.reranker_model:
            right += f" + {state.stats.reranker_model}"
    _safe_add(stdscr, h - 1, 1, left, _attr(theme.ok))
    _safe_add(stdscr, h - 1, max(0, w - len(right) - 2), right, _attr(theme.dim))
