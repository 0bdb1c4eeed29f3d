"""(Copy of transfuser_tpu/harness/result_writer.py.)

Per-route terminal result table.

Behavioral spec: leaderboard/utils/result_writer.py:19-116
(ResultOutputProvider) — a fancy-grid table of simulation timings followed
by one row per criterion with green SUCCESS / red FAILURE and a
criterion-specific value column, plus the timeout row. tabulate-free:
draws the box with unicode rules like tabulate's 'fancy_grid'.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

GREEN = "\033[92m"
RED = "\033[91m"
BOLD = "\033[1m"
RESET = "\033[0m"


def _strip_ansi(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\033":
            while i < len(s) and s[i] != "m":
                i += 1
            i += 1
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def fancy_grid(rows: Sequence[Sequence[str]]) -> str:
    """Minimal tabulate(tablefmt='fancy_grid') clone, ANSI-aware."""
    cells = [[str(c) for c in row] for row in rows]
    ncol = max(len(r) for r in cells)
    for r in cells:
        r.extend([""] * (ncol - len(r)))
    widths = [max(len(_strip_ansi(r[i])) for r in cells)
              for i in range(ncol)]

    def rule(left: str, mid: str, right: str, fill: str = "═") -> str:
        return left + mid.join(fill * (w + 2) for w in widths) + right

    def line(row: Sequence[str]) -> str:
        parts = []
        for i, c in enumerate(row):
            pad = widths[i] - len(_strip_ansi(c))
            parts.append(f" {c}{' ' * pad} ")
        return "│" + "│".join(parts) + "│"

    out = [rule("╒", "╤", "╕")]
    for i, row in enumerate(cells):
        out.append(line(row))
        out.append(rule("├", "┼", "┤", "─") if i < len(cells) - 1
                   else rule("╘", "╧", "╛"))
    return "\n".join(out)


def _criterion_value(criterion) -> str:
    """Criterion-specific value column (result_writer.py:85-96)."""
    name = getattr(criterion, "name", type(criterion).__name__)
    if name == "RouteCompletionTest":
        return f"{getattr(criterion, 'percentage', 0.0):.2f} %"
    if name == "OutsideRouteLanesTest":
        driven = getattr(criterion, "_driven_distance", 0.0)
        outside = getattr(criterion, "_outside_distance", 0.0)
        return f"{100.0 * outside / max(driven, 1e-9):.2f} %"
    if name in ("CollisionTest", "RunningRedLightTest", "RunningStopTest"):
        return f"{len(criterion.events)} times"
    if name in ("InRouteTest", "AgentBlockedTest"):
        return ""
    return str(len(criterion.events))


class ResultOutputProvider:
    """Builds/prints the per-route results table."""

    def __init__(self, route_name: str, global_result: str,
                 duration_system: float, duration_game: float,
                 criteria: Sequence, timeout: Optional[float] = None,
                 start_system_time: Optional[float] = None,
                 repetition: int = 0, stdout: bool = True):
        self.route_name = route_name
        self.global_result = global_result
        self.duration_system = duration_system
        self.duration_game = duration_game
        self.criteria = list(criteria)
        self.timeout = timeout
        self.start_system_time = start_system_time or time.time()
        self.repetition = repetition
        if stdout:
            print(self.create_output_text())

    def create_output_text(self) -> str:
        start = time.strftime("%Y-%m-%d %H:%M:%S",
                              time.localtime(self.start_system_time))
        end = time.strftime(
            "%Y-%m-%d %H:%M:%S",
            time.localtime(self.start_system_time + self.duration_system))
        out = "\n"
        out += (f"{BOLD}========= Results of {self.route_name} "
                f"(repetition {self.repetition}) ------ "
                f"{self.global_result} {BOLD}========={RESET}\n\n")

        sys_t = round(self.duration_system, 2)
        game_t = round(self.duration_game, 2)
        # reference parity quirk: result_writer.py:55 computes
        # game/system while labeling the row "System Time / Game Time";
        # reproduced verbatim so tables compare 1:1.
        ratio = round(self.duration_game / max(self.duration_system, 1e-9),
                      3)
        out += fancy_grid([
            ["Start Time", start],
            ["End Time", end],
            ["Duration (System Time)", f"{sys_t}s"],
            ["Duration (Game Time)", f"{game_t}s"],
            ["Ratio (System Time / Game Time)", f"{ratio}"],
        ])
        out += "\n\n"

        rows: List[List[str]] = [["Criterion", "Result", "Value"]]
        for criterion in self.criteria:
            status = criterion.test_status
            if status in ("SUCCESS", "INIT"):
                shown = f"{GREEN}SUCCESS{RESET}"
            elif status == "FAILURE":
                shown = f"{RED}FAILURE{RESET}"
            else:
                shown = status
            rows.append([getattr(criterion, "name",
                                 type(criterion).__name__),
                         shown, _criterion_value(criterion)])
        if self.timeout is not None:
            timed_out = self.duration_game >= self.timeout
            rows.append(["Timeout",
                         f"{RED}FAILURE{RESET}" if timed_out
                         else f"{GREEN}SUCCESS{RESET}", ""])
        out += fancy_grid(rows)
        out += "\n"
        return out
