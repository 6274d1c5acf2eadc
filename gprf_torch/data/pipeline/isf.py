"""ISC/IDC bulletin parsing and uncertainty heuristics (a copy of
``gprf_tpu/data/pipeline/isf.py``).

Fixed-width ISF hypocenter-line parsing (:func:`ev_from_line`), the
bulletin-page event extractor, the query URL of the ISC mirror's web
service (:func:`isc_query_url` only builds the string: fetching is the
caller's concern), and the ``fakescrape`` magnitude-to-location-error
heuristic.
"""

from __future__ import annotations

import calendar
from datetime import datetime, timezone

import numpy as np


class CouldNotScrapeException(Exception):
    pass


(
    TIMESTAMP_COL, TERR_COL, TRMS_COL, LON_COL, LAT_COL, SMAJ_COL, SMIN_COL,
    STRIKE_COL, DEPTH_COL, DERR_COL, METHOD_COL, SOURCE_COL, ISCID_COL,
    N_ISC_COLS,
) = range(14)


def ev_from_line(line):
    """(source, hypocenter-tuple) from one fixed-width ISF origin line.

    Column layout per the ISF 1.0 origin block (reference
    ``scrape_seismic.py:15-76``).
    """
    try:
        evdate = line[:10]
        yr, mo, day = int(evdate[:4]), int(evdate[5:7]), int(evdate[8:])
        evtime = line[11:22]
        hr, mn = int(evtime[:2]), int(evtime[3:5])
        ss = float(evtime[6:])
        s = int(ss)
        ms = float(ss - s)
        dt = datetime(yr, mo, day, hr, mn, s)
        ts = calendar.timegm(dt.timetuple()) + ms
    except Exception:
        ts = -1

    def _f(a, b, default):
        try:
            return float(line[a:b])
        except (ValueError, IndexError):
            return default

    time_err = _f(24, 29, -1.0)
    time_rms = _f(30, 35, -1.0)
    lat = float(line[36:44])
    lon = float(line[45:54])
    try:
        smaj = float(line[55:60])
        smin = float(line[61:66])
        strike = int(line[67:70])
    except (ValueError, IndexError):
        smaj, smin, strike = 20.0, 20.0, 0
    depth = _f(71, 76, 0.0)
    depth_err = _f(78, 82, 0.05 * depth + 1.0)
    method = line[113] if len(line) > 113 else " "
    source = line[118:127].strip() if len(line) > 118 else ""
    try:
        iscid = int(line[129:136])
    except (ValueError, IndexError):
        iscid = -1
    return source, (
        ts, time_err, time_rms, lon, lat, smaj, smin, strike, depth,
        depth_err, method, source, iscid,
    )


def extract_ev(page, target_lon=None):
    """Per-bulletin hypocenters {source: tuple} from an ISF result page
    (reference ``scrape_seismic.py:78-117``)."""
    if "No events were found" in page:
        raise CouldNotScrapeException()
    try:
        idx1 = page.index("<pre>") + 6
        idx2 = page.index("STOP")
        lines = page[idx1:idx2].split("\n")
        ev_hcenters = {}
        for line in lines:
            if "PRIME" in line:
                break
            if not line.startswith("20"):
                continue
            try:
                bulletin, hcenter = ev_from_line(line)
            except Exception:
                continue
            ev_hcenters[bulletin] = hcenter
        if not ev_hcenters:
            raise CouldNotScrapeException()
        return ev_hcenters
    except CouldNotScrapeException:
        raise
    except Exception as e:
        raise CouldNotScrapeException(str(e))


def isc_query_url(lon, lat, ev_time, radius_km=80):
    """ISC mirror COMPREHENSIVE/ISF circular query URL (reference
    ``scrape_seismic.py:125-129``).  The caller performs the fetch."""
    sdt = datetime.fromtimestamp(ev_time - 120, tz=timezone.utc)
    edt = datetime.fromtimestamp(ev_time + 120, tz=timezone.utc)
    stime = "%02d:%02d:%02d" % (sdt.hour, sdt.minute, sdt.second)
    etime = "%02d:%02d:%02d" % (edt.hour, edt.minute, edt.second)
    return (
        "http://isc-mirror.iris.washington.edu/cgi-bin/web-db-v4?out_format=ISF"
        "&request=COMPREHENSIVE&searchshape=CIRC&ctr_lat=%.2f&ctr_lon=%.2f"
        "&radius=%d&max_dist_units=km&start_year=%d&start_month=%d&start_day=%d"
        "&start_time=%s&end_year=%d&end_month=%d&end_day=%d&end_time=%s"
        "&req_mag_agcy=Any"
        % (lat, lon, radius_km, sdt.year, sdt.month, sdt.day, stime,
           edt.year, edt.month, edt.day, etime)
    )


def fakescrape(lon, lat, depth, mb):
    """Magnitude-based location-uncertainty prior: error_km = 400 / 2**mb
    (reference ``scrape_seismic.py:145-159``).

    Returns (lon, lat, smaj, smin, strike, depth, depth_err).
    """
    error_km = 400.0 / np.exp(mb * np.log(2))
    return lon, lat, error_km, error_km, 0, depth, error_km
