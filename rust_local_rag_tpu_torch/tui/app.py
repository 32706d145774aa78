"""TUI state machine — Elm-style messages + update() (cf. bin/rag_tui/app.rs:
Msg::update at :863-927, stale-search-id guard at :448-455); a copy of
rust_local_rag_tpu/tui/app.py."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

from rust_local_rag_tpu_torch.tui.api import JobStatus, Stats, TuiSearchResult


class Mode(str, Enum):
    NORMAL = "normal"
    DETAIL = "detail"
    HELP = "help"
    SETTINGS = "settings"


@dataclass
class Msg:
    """Message union (kind + payload)."""

    kind: str
    payload: object = None


@dataclass
class AppState:
    query: str = ""
    cursor: int = 0
    mode: Mode = Mode.NORMAL
    results: List[TuiSearchResult] = field(default_factory=list)
    selected: int = 0
    search_id: int = 0          # monotonically increasing request id
    searching: bool = False
    stats: Optional[Stats] = None
    healthy: bool = True
    job: Optional[JobStatus] = None
    status_line: str = ""
    detail_scroll: int = 0
    settings_selected: int = 0
    settings_editing: bool = False
    settings_edit_buffer: str = ""
    settings_cursor: int = 0  # char index into the edit buffer (ui.rs cursor block)
    theme_name: str = "default"
    quit: bool = False

    # ----- query editing -----

    def insert_char(self, ch: str) -> None:
        self.query = self.query[: self.cursor] + ch + self.query[self.cursor:]
        self.cursor += len(ch)

    def backspace(self) -> None:
        if self.cursor > 0:
            self.query = (
                self.query[: self.cursor - 1] + self.query[self.cursor:]
            )
            self.cursor -= 1

    def clear_query(self) -> None:
        self.query = ""
        self.cursor = 0
        self.results = []
        self.selected = 0

    # ----- search lifecycle (stale-id guard, app.rs:430-455) -----

    def start_search(self) -> int:
        """Returns the new search id; the worker must echo it back."""
        self.search_id += 1
        self.searching = True
        return self.search_id

    def complete_search(
        self, search_id: int, results: List[TuiSearchResult]
    ) -> bool:
        """Apply results only if they belong to the latest request."""
        if search_id != self.search_id:
            return False  # stale — a newer search is in flight
        self.results = results
        self.selected = 0
        self.searching = False
        self.status_line = f"{len(results)} results"
        return True

    def fail_search(self, search_id: int, error: str) -> bool:
        if search_id != self.search_id:
            return False
        self.searching = False
        self.results = []
        self.status_line = f"search failed: {error}"
        return True

    # ----- navigation -----

    def move_selection(self, delta: int) -> None:
        if self.results:
            self.selected = max(0, min(len(self.results) - 1, self.selected + delta))

    def selected_result(self) -> Optional[TuiSearchResult]:
        if 0 <= self.selected < len(self.results):
            return self.results[self.selected]
        return None

    # ----- update (message dispatch) -----

    def update(self, msg: Msg) -> None:
        k = msg.kind
        if k == "quit":
            self.quit = True
        elif k == "char":
            if self.mode == Mode.NORMAL:
                self.insert_char(str(msg.payload))
        elif k == "backspace":
            if self.mode == Mode.NORMAL:
                self.backspace()
        elif k == "clear":
            self.clear_query()
        elif k == "up":
            if self.mode == Mode.DETAIL:
                self.detail_scroll = max(0, self.detail_scroll - 1)
            elif self.mode == Mode.SETTINGS:
                self.settings_selected = max(0, self.settings_selected - 1)
            else:
                self.move_selection(-1)
        elif k == "down":
            if self.mode == Mode.DETAIL:
                self.detail_scroll += 1
            elif self.mode == Mode.SETTINGS:
                self.settings_selected += 1
            else:
                self.move_selection(1)
        elif k == "enter_detail":
            if self.selected_result() is not None:
                self.mode = Mode.DETAIL
                self.detail_scroll = 0
        elif k == "back":
            if self.mode in (Mode.DETAIL, Mode.HELP, Mode.SETTINGS):
                self.mode = Mode.NORMAL
                self.settings_editing = False
        elif k == "help":
            self.mode = Mode.HELP if self.mode != Mode.HELP else Mode.NORMAL
        elif k == "settings":
            self.mode = (
                Mode.SETTINGS if self.mode != Mode.SETTINGS else Mode.NORMAL
            )
        elif k == "search_done":
            search_id, results = msg.payload
            self.complete_search(search_id, results)
        elif k == "search_failed":
            search_id, error = msg.payload
            self.fail_search(search_id, error)
        elif k == "stats":
            self.stats = msg.payload
        elif k == "health":
            self.healthy = bool(msg.payload)
        elif k == "job_update":
            self.job = msg.payload
            if self.job is not None and self.job.status in ("completed", "failed"):
                note = (
                    "reindex completed"
                    if self.job.status == "completed"
                    else f"reindex failed: {self.job.error}"
                )
                self.status_line = note
        elif k == "status":
            self.status_line = str(msg.payload)

    @property
    def reindexing(self) -> bool:
        return self.job is not None and self.job.status in ("pending", "inprogress")
