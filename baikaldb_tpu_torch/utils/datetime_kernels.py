"""Branch-free calendar math on integer tensors.

The port of ``baikaldb_tpu/utils/datetime_kernels.py``: DATE is int32 epoch
days, DATETIME int64 epoch microseconds, and every datetime scalar function
is integer arithmetic (Howard Hinnant's public-domain days_from_civil /
civil_from_days), with MySQL's week modes and calendar month shifts.
"""

from __future__ import annotations

import torch

US_PER_SEC = 1_000_000
US_PER_MIN = 60 * US_PER_SEC
US_PER_HOUR = 60 * US_PER_MIN
US_PER_DAY = 24 * US_PER_HOUR


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z):
    """Epoch days -> (year, month, day) int32 tensors."""
    z = z.to(torch.int32) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                    # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                               # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                       # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)                       # [1, 12]
    y = y + (m <= 2).to(y.dtype)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y, m, d):
    """(year, month, day) int tensors -> epoch days (int32)."""
    m = m.to(torch.int32)
    y = y.to(torch.int32) - (m <= 2).to(torch.int32)
    d = d.to(torch.int32)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def dt_days(us):
    """DATETIME micros -> epoch days (floored, handles pre-1970)."""
    return _fdiv(us, US_PER_DAY).to(torch.int32)


def dt_time_of_day_us(us):
    return us - _fdiv(us, US_PER_DAY) * US_PER_DAY


def year_of_days(days):
    return civil_from_days(days)[0]


def month_of_days(days):
    return civil_from_days(days)[1]


def day_of_days(days):
    return civil_from_days(days)[2]


def quarter_of_days(days):
    m = civil_from_days(days)[1]
    return (_fdiv(m - 1, 3) + 1).to(torch.int32)


def day_of_week(days):
    """MySQL DAYOFWEEK: 1=Sunday .. 7=Saturday; epoch day 0 was a Thursday."""
    return (torch.remainder(days.to(torch.int32) + 4, 7) + 1).to(torch.int32)


def weekday(days):
    """MySQL WEEKDAY: 0=Monday .. 6=Sunday."""
    return torch.remainder(days.to(torch.int32) + 3, 7).to(torch.int32)


def day_of_year(days):
    y, _, _ = civil_from_days(days)
    one = torch.ones_like(y)
    return (days.to(torch.int32) - days_from_civil(y, one, one) + 1).to(torch.int32)


def last_day(days):
    """Epoch days -> epoch days of the last day of that month."""
    y, m, _ = civil_from_days(days)
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    return days_from_civil(ny, nm, torch.ones_like(ny)) - 1


def week_mode0(days):
    """MySQL WEEK(d) in mode 0 (python strftime %U): weeks start on Sunday,
    00-53; week 1 begins on the year's first Sunday, earlier days are week
    0."""
    days = days.to(torch.int32)
    doy = day_of_year(days)                             # 1-based
    jan1 = days - (doy - 1)
    s = torch.remainder(weekday(jan1) + 1, 7)           # Sunday = 0
    first_sunday = 1 + torch.remainder(7 - s, 7)        # its day of the year
    return _fdiv(doy + 7 - first_sunday, 7).to(torch.int32)


def week(days, mode):
    """MySQL WEEK(d, mode) for modes 0-7 (``mode & 7``; an int or a tensor
    of them), MySQL's ``calc_week`` over whole tensors.  The mode's bits:
    1 weeks start on Monday, 2 the range is 1-53 (a week 0 is the previous
    year's last), 4 week 1 is the first with a start-of-week day in the year
    (else the first with 4 or more days); mode 0 is ``week_mode0``, mode 3
    ISO 8601 (``iso_week``)."""
    days = days.to(torch.int32)
    mode = torch.as_tensor(mode, dtype=torch.int32, device=days.device) & 7
    monday_first = (mode & 1) != 0
    # MySQL's week_mode: a Sunday-first mode reads its "4 or more days"
    # bit inverted
    first_weekday = ((mode & 4) != 0) ^ ~monday_first
    week_year = (mode & 2) != 0
    doy = day_of_year(days)
    first = days - (doy - 1)                            # Jan 1 of the year
    y = year_of_days(days)
    one = torch.ones_like(y)

    def start_day(jan1):
        """Day of the week of ``jan1``, 0 = the first day of a week."""
        wd = weekday(jan1)                              # 0 = Monday
        return torch.where(monday_first, wd, torch.remainder(wd + 1, 7))

    wd = start_day(first)
    late_start = torch.where(first_weekday, wd != 0, wd >= 4)
    in_first = doy <= 7 - wd
    zero = in_first & ~week_year & late_start
    # the first days of a year that belong to the previous year's last week
    prev = in_first & ~zero
    prev_first = days_from_civil(y - 1, one, one)
    first = torch.where(prev, prev_first, first)
    wd = torch.where(prev, start_day(prev_first), wd)
    y = torch.where(prev, y - 1, y)
    late_start = torch.where(first_weekday, wd != 0, wd >= 4)
    n = days - torch.where(late_start, first + 7 - wd, first - wd)
    # the last days of a year that belong to the next year's week 1
    year_len = days_from_civil(y + 1, one, one) - first
    wd_next = torch.remainder(wd + year_len, 7)
    next_one = (week_year | prev) & (n >= 52 * 7) & \
        torch.where(first_weekday, wd_next == 0, wd_next < 4)
    out = torch.where(next_one, one, _fdiv(n, 7) + 1)
    return torch.where(zero, torch.zeros_like(out), out).to(torch.int32)


def iso_week(days):
    """ISO-8601 week number (MySQL WEEKOFYEAR, which is WEEK(d, 3))."""
    days = days.to(torch.int32)
    thu = days - weekday(days) + 3                      # this ISO week's Thursday
    return (_fdiv(day_of_year(thu) - 1, 7) + 1).to(torch.int32)


def shift_months(days, n):
    """Calendar month shift with MySQL's day clamping (2024-01-31 plus one
    month is 2024-02-29)."""
    y, m, d = civil_from_days(days)
    total = y * 12 + (m - 1) + n.to(torch.int32)
    ny = _fdiv(total, 12)
    nm = torch.remainder(total, 12) + 1
    maxd = civil_from_days(last_day(days_from_civil(ny, nm, torch.ones_like(ny))))[2]
    return days_from_civil(ny, nm, torch.minimum(d, maxd))
