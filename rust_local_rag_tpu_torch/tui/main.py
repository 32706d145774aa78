"""rag-tui event loop: curses rendering + background workers
(cf. bin/rag_tui/main.rs — biased select loop at :122, keymaps :126-521,
poll timers :557-608; port of rust_local_rag_tpu/tui/main.py).

Keys (NORMAL): type to search (debounced), Enter opens detail, Up/Down
select, Ctrl-R reindex, Ctrl-T theme, F1/? help, F2 settings, Ctrl-U clear,
Ctrl-Y copy selected result text (OSC52 clipboard — works over SSH),
Esc/Ctrl-C quit.
DETAIL: Up/Down scroll, Esc back. SETTINGS: Up/Down select, Enter edit,
Enter saves the field, Ctrl-S writes .env, Esc back.
"""

from __future__ import annotations

import curses
import os
import queue
import threading
import time
from typing import Optional

from rust_local_rag_tpu_torch.tui.api import ApiClient
from rust_local_rag_tpu_torch.tui.app import AppState, Mode, Msg
from rust_local_rag_tpu_torch.tui.settings import Settings
from rust_local_rag_tpu_torch.tui.theme import get_theme, next_theme
from rust_local_rag_tpu_torch.tui import ui

SEARCH_DEBOUNCE_S = 0.25
STATS_INTERVAL_S = 2.0
HEALTH_INTERVAL_S = 5.0
JOB_INTERVAL_S = 1.0


class Controller:
    def __init__(self, api: ApiClient, state: AppState, settings: Settings):
        self.api = api
        self.state = state
        self.settings = settings
        self.msgs: "queue.Queue[Msg]" = queue.Queue()
        self._pending_query: Optional[str] = None
        self._pending_at = 0.0
        self._apply_client = {
            # client-side keys applied to the live session immediately
            # (everything else is server-side: requires_restart)
            "RAG_TUI_SERVER_URL": self._repoint_api,
        }
        self._last_stats = 0.0
        self._last_health = 0.0
        self._last_job = 0.0
        self._job_id: Optional[str] = None
        self._stop = threading.Event()
        # server-push job progress over the MCP SSE channel; the 1 s
        # polling in tick() stays as the fallback when the channel is down
        threading.Thread(target=self._watch_jobs, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()

    def apply_client_setting(self, key: str) -> None:
        """Apply a client-only setting to the live session (server keys
        need a restart and carry the '(restart)' marker instead)."""
        fn = self._apply_client.get(key)
        if fn is not None:
            fn()

    def _repoint_api(self) -> None:
        url = self.settings.get("RAG_TUI_SERVER_URL") or "http://127.0.0.1:3046"
        self.api.base_url = url.rstrip("/")
        self.state.status_line = f"server -> {self.api.base_url}"

    def _watch_jobs(self) -> None:
        while not self._stop.is_set():
            try:
                self.api.watch_jobs(
                    lambda job: self.msgs.put(Msg("job_update", job)),
                    self._stop.is_set,
                )
            except Exception:  # noqa: BLE001
                pass
            self._stop.wait(2.0)  # reconnect backoff

    # ----- background work -----

    def _spawn_search(self, query: str) -> None:
        sid = self.state.start_search()

        def worker() -> None:
            try:
                results = self.api.search(query, top_k=10)
                self.msgs.put(Msg("search_done", (sid, results)))
            except Exception as e:  # noqa: BLE001
                self.msgs.put(Msg("search_failed", (sid, str(e))))

        threading.Thread(target=worker, daemon=True).start()

    def schedule_search(self) -> None:
        self._pending_query = self.state.query
        self._pending_at = time.monotonic() + SEARCH_DEBOUNCE_S

    def start_reindex(self) -> None:
        def worker() -> None:
            try:
                job = self.api.start_reindex()
                self._job_id = job.job_id
                self.msgs.put(Msg("job_update", job))
                self.msgs.put(Msg("status", f"reindex started: {job.job_id[:8]}"))
            except Exception as e:  # noqa: BLE001
                self.msgs.put(Msg("status", f"reindex: {e}"))

        threading.Thread(target=worker, daemon=True).start()

    def tick(self) -> None:
        """Timers: debounced search, stats/health/job polling."""
        now = time.monotonic()
        if (
            self._pending_query is not None
            and now >= self._pending_at
        ):
            q = self._pending_query
            self._pending_query = None
            if q.strip():
                self._spawn_search(q)
            else:
                self.state.results = []

        if now - self._last_stats > STATS_INTERVAL_S:
            self._last_stats = now
            threading.Thread(target=self._poll_stats, daemon=True).start()
        if now - self._last_health > HEALTH_INTERVAL_S:
            self._last_health = now
            threading.Thread(target=self._poll_health, daemon=True).start()
        if (
            self.state.reindexing or self._job_id
        ) and now - self._last_job > JOB_INTERVAL_S:
            self._last_job = now
            threading.Thread(target=self._poll_job, daemon=True).start()

    def _poll_stats(self) -> None:
        try:
            self.msgs.put(Msg("stats", self.api.stats()))
        except Exception:  # noqa: BLE001
            pass

    def _poll_health(self) -> None:
        self.msgs.put(Msg("health", self.api.health()))

    def _poll_job(self) -> None:
        try:
            job = (
                self.api.job_status(self._job_id)
                if self._job_id
                else self.api.active_job()
            )
            if job is not None:
                self.msgs.put(Msg("job_update", job))
                if job.status in ("completed", "failed"):
                    self._job_id = None
        except Exception:  # noqa: BLE001
            pass


def _handle_key(ch: int, state: AppState, ctl: Controller) -> None:
    if state.mode == Mode.SETTINGS:
        _handle_settings_key(ch, state, ctl)
        return
    if ch in (27,):  # Esc
        if state.mode == Mode.NORMAL:
            state.update(Msg("quit"))
        else:
            state.update(Msg("back"))
    elif ch == 3:  # Ctrl-C
        state.update(Msg("quit"))
    elif ch == curses.KEY_UP:
        state.update(Msg("up"))
    elif ch == curses.KEY_DOWN:
        state.update(Msg("down"))
    elif ch in (curses.KEY_ENTER, 10, 13):
        state.update(Msg("enter_detail"))
    elif ch == 18:  # Ctrl-R
        ctl.start_reindex()
    elif ch == 20:  # Ctrl-T
        state.theme_name = next_theme(state.theme_name)
    elif ch == 21:  # Ctrl-U
        state.update(Msg("clear"))
    elif ch == 25:  # Ctrl-Y: copy selected result text to the clipboard
        r = state.selected_result()
        if r is not None:
            _osc52_copy(r.text)
            state.status_line = "copied result text to clipboard"
    elif ch in (curses.KEY_F1,) or (
        state.mode != Mode.NORMAL and ch == ord("?")
    ):
        state.update(Msg("help"))
    elif ch == curses.KEY_F2:
        state.update(Msg("settings"))
    elif ch in (curses.KEY_BACKSPACE, 127, 8):
        state.update(Msg("backspace"))
        ctl.schedule_search()
    elif 32 <= ch < 127:
        state.update(Msg("char", chr(ch)))
        ctl.schedule_search()


def _handle_settings_key(ch: int, state: AppState, ctl: Controller) -> None:
    from rust_local_rag_tpu_torch.tui.settings import SETTING_KEYS

    nrows = len(SETTING_KEYS)
    if ch == 3:  # Ctrl-C: raw mode delivers it as a key; keep quit working
        state.update(Msg("quit"))
        return
    if state.settings_editing:
        buf, cur = state.settings_edit_buffer, state.settings_cursor
        if ch in (curses.KEY_ENTER, 10, 13):
            key = SETTING_KEYS[state.settings_selected][0]
            err = ctl.settings.set(key, buf)
            if not err or err.startswith("warning:"):
                ctl.apply_client_setting(key)
            state.status_line = err or f"{key} updated (Ctrl-S to save)"
            # hard validation errors keep the editor open for correction;
            # warnings were applied (settings.rs Warning semantics)
            if not err or err.startswith("warning:"):
                state.settings_editing = False
        elif ch == 27:
            state.settings_editing = False
        elif ch in (curses.KEY_BACKSPACE, 127, 8):
            if cur > 0:
                state.settings_edit_buffer = buf[: cur - 1] + buf[cur:]
                state.settings_cursor = cur - 1
        elif ch == curses.KEY_DC:  # Delete: remove char AT cursor
            if cur < len(buf):
                state.settings_edit_buffer = buf[:cur] + buf[cur + 1 :]
        elif ch == curses.KEY_LEFT:
            state.settings_cursor = max(0, cur - 1)
        elif ch == curses.KEY_RIGHT:
            state.settings_cursor = min(len(buf), cur + 1)
        elif ch in (curses.KEY_HOME, 1):  # Home / Ctrl-A
            state.settings_cursor = 0
        elif ch in (curses.KEY_END, 5):  # End / Ctrl-E
            state.settings_cursor = len(buf)
        elif 32 <= ch < 127:
            state.settings_edit_buffer = buf[:cur] + chr(ch) + buf[cur:]
            state.settings_cursor = cur + 1
        return
    if ch == 27:
        state.update(Msg("back"))
    elif ch == curses.KEY_UP:
        state.settings_selected = max(0, state.settings_selected - 1)
    elif ch == curses.KEY_DOWN:
        state.settings_selected = min(nrows - 1, state.settings_selected + 1)
    elif ch in (curses.KEY_LEFT, curses.KEY_RIGHT):
        # model-discovery dropdown (the reference's Ollama /api/tags
        # dropdowns, ollama.rs:71-111): cycle locally discovered
        # checkpoints / hermetic modes for keys that have them
        from rust_local_rag_tpu_torch.models.discovery import choices_for_key

        key = SETTING_KEYS[state.settings_selected][0]
        choices = choices_for_key(key)
        if not choices:
            state.status_line = f"{key}: no discoverable choices"
            return
        current = ctl.settings.get(key)
        try:
            pos = choices.index(current)
        except ValueError:
            pos = -1
        step = 1 if ch == curses.KEY_RIGHT else -1
        nxt = choices[(pos + step) % len(choices)]
        err = ctl.settings.set(key, nxt)
        if not err or err.startswith("warning:"):
            ctl.apply_client_setting(key)
        state.status_line = err or (
            f"{key} = {nxt or '(empty)'} (Ctrl-S to save)"
        )
    elif ch in (curses.KEY_ENTER, 10, 13):
        key = SETTING_KEYS[state.settings_selected][0]
        state.settings_edit_buffer = ctl.settings.get(key)
        state.settings_cursor = len(state.settings_edit_buffer)
        state.settings_editing = True
    elif ch == 19:  # Ctrl-S
        try:
            ctl.settings.save()
            state.status_line = f"saved {ctl.settings.path}"
        except OSError as e:
            state.status_line = f"save failed: {e}"


def _osc52_copy(text: str) -> None:
    """Clipboard copy via the OSC52 escape sequence (terminal-mediated, so
    it works in SSH sessions where the reference's arboard cannot)."""
    import base64
    import sys

    payload = base64.b64encode(text.encode("utf-8")).decode("ascii")
    sys.stdout.write(f"\x1b]52;c;{payload}\x07")
    sys.stdout.flush()


# escape-sequence tails -> curses keys, for sequences that arrive SPLIT
# from their ESC byte (laggy SSH / pty): in nodelay mode curses hands us a
# bare 27 and then the tail as individual chars, which without this would
# quit the app and type "[B" into the search box.
_ESC_TAILS = {
    "[A": curses.KEY_UP, "OA": curses.KEY_UP,
    "[B": curses.KEY_DOWN, "OB": curses.KEY_DOWN,
    "[C": curses.KEY_RIGHT, "OC": curses.KEY_RIGHT,
    "[D": curses.KEY_LEFT, "OD": curses.KEY_LEFT,
    "[H": curses.KEY_HOME, "OH": curses.KEY_HOME, "[1~": curses.KEY_HOME,
    "[F": curses.KEY_END, "OF": curses.KEY_END, "[4~": curses.KEY_END,
    "[3~": curses.KEY_DC,
    "OP": curses.KEY_F1, "[11~": curses.KEY_F1,
    "OQ": curses.KEY_F2, "[12~": curses.KEY_F2,
}


def _resolve_escape(stdscr) -> int:
    """Called after a bare ESC (27) in nodelay mode: wait briefly for a
    sequence tail; return the mapped key, 27 for a genuine lone ESC, or -1
    for an unrecognized sequence (swallowed, not typed into the query)."""
    time.sleep(0.03)
    tail = ""
    retries = 0
    while len(tail) < 8:
        nxt = stdscr.getch()
        if nxt == -1:
            # a split tail can straggle past the first poll (SSH jitter):
            # re-sleep a few times while the accumulated tail is still a
            # prefix of some known sequence, instead of swallowing it
            if retries < 3 and (
                not tail or any(s.startswith(tail) for s in _ESC_TAILS)
            ):
                retries += 1
                time.sleep(0.01)
                continue
            break
        if nxt == 27:
            if not tail:
                # two rapid Esc presses: this one is a genuine lone ESC;
                # push the second back so it fires its own action too
                curses.ungetch(27)
                return 27
            return -1
        if 32 <= nxt < 127:
            tail += chr(nxt)
            if tail in _ESC_TAILS:
                return _ESC_TAILS[tail]
        else:
            return -1  # non-ASCII mid-sequence: drop it
    if not tail:
        return 27  # genuine lone ESC
    return -1


def run(stdscr, base_url: str, env_path: str) -> None:
    # raw mode (not just cbreak): with IXON left on, the terminal driver
    # swallows Ctrl-S as XOFF and the save binding never reaches the app
    # (the reference's crossterm raw mode disables flow control the same
    # way). Ctrl-C stops sending SIGINT under raw, but the keymap handles
    # ch==3 as quit itself.
    curses.raw()
    curses.curs_set(1)
    stdscr.nodelay(True)
    stdscr.keypad(True)
    ui.init_colors()

    api = ApiClient(base_url)
    state = AppState()
    settings = Settings.load(env_path)
    ctl = Controller(api, state, settings)

    try:
        while not state.quit:
            ctl.tick()
            try:
                while True:
                    state.update(ctl.msgs.get_nowait())
            except queue.Empty:
                pass

            ui.draw(stdscr, state, settings, get_theme(state.theme_name))

            ch = stdscr.getch()
            if ch == 27:
                ch = _resolve_escape(stdscr)
            if ch != -1:
                _handle_key(ch, state, ctl)
            else:
                time.sleep(0.03)
    finally:
        ctl.stop()


def main() -> int:
    base_url = os.environ.get("RAG_TUI_SERVER_URL") or "http://" + os.environ.get(
        "MCP_HTTP_BIND", "127.0.0.1:3046"
    )
    env_path = os.environ.get("RAG_TUI_ENV_PATH", ".env")
    curses.wrapper(run, base_url, env_path)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
