"""Model time and calendar handling.

Analog of the reference ``src/base/TimeObj.{h,cpp}``: a ``Time``
value type with calendar-aware arithmetic and parsing of duration strings
like ``"200s"``, ``"30d"``, ``"1.5h"`` used by ``--dt`` / ``--endtime``.

Host-side only: the driver carries model time as a Python float of
"seconds since start"; nothing here touches a tensor.
"""

from __future__ import annotations

import dataclasses
import enum
import re


class Calendar(enum.Enum):
    NONE = "none"          # pure elapsed seconds
    NO_LEAP = "noleap"     # 365-day calendar
    STANDARD = "standard"  # Gregorian


_DAYS_IN_MONTH_NOLEAP = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]

_DURATION_RE = re.compile(r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([a-zA-Z]*)\s*$")

_UNIT_SECONDS = {
    "": 1.0,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
    "d": 86400.0,
}


def parse_duration_seconds(text) -> float:
    """Parse a Tempest-style duration string ("200s", "30d", "1.5h") to seconds.

    Reference: ``TimeObj::FromFormattedString`` duration branch
    (``src/base/TimeObj.cpp``).  Also accepts bare numbers (= seconds) and
    floats passed through unchanged.
    """
    if isinstance(text, (int, float)):
        return float(text)
    m = _DURATION_RE.match(text)
    if not m:
        raise ValueError(f"Cannot parse duration: {text!r}")
    value, unit = float(m.group(1)), m.group(2).lower()
    if unit not in _UNIT_SECONDS:
        raise ValueError(f"Unknown time unit {unit!r} in {text!r}")
    return value * _UNIT_SECONDS[unit]


@dataclasses.dataclass(frozen=True, order=True)
class Time:
    """A calendar date-time with second resolution plus fractional seconds."""

    year: int = 0
    month: int = 1
    day: int = 1
    seconds: float = 0.0          # seconds into the day
    calendar: Calendar = dataclasses.field(default=Calendar.NONE, compare=False)

    # -- elapsed-seconds representation (calendar NONE uses only .seconds) --
    def as_seconds(self) -> float:
        """Total elapsed seconds since year 0 (NO_LEAP/NONE calendars)."""
        if self.calendar == Calendar.NONE:
            return self.seconds
        days = self.year * 365 + sum(_DAYS_IN_MONTH_NOLEAP[: self.month - 1]) \
            + (self.day - 1)
        return days * 86400.0 + self.seconds

    def add_seconds(self, dt: float) -> "Time":
        if self.calendar == Calendar.NONE:
            return dataclasses.replace(self, seconds=self.seconds + dt)
        total = self.as_seconds() + dt
        return Time.from_seconds(total, self.calendar)

    @staticmethod
    def from_seconds(total: float, calendar: Calendar = Calendar.NONE) -> "Time":
        if calendar == Calendar.NONE:
            return Time(seconds=total, calendar=calendar)
        days, secs = divmod(total, 86400.0)
        days = int(days)
        year, days = divmod(days, 365)
        month = 1
        for dim in _DAYS_IN_MONTH_NOLEAP:
            if days < dim:
                break
            days -= dim
            month += 1
        return Time(year=year, month=month, day=days + 1, seconds=secs,
                    calendar=calendar)

    def __sub__(self, other: "Time") -> float:
        return self.as_seconds() - other.as_seconds()

    def pretty(self) -> str:
        if self.calendar == Calendar.NONE:
            return f"{self.seconds:.3f}s"
        h, rem = divmod(self.seconds, 3600.0)
        mi, s = divmod(rem, 60.0)
        return (f"{self.year:04d}-{self.month:02d}-{self.day:02d}"
                f" {int(h):02d}:{int(mi):02d}:{s:06.3f}")
