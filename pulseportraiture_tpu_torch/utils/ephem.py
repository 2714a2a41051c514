"""Observatory geometry: Doppler factors and parallactic angles.

The reference takes both quantities per subintegration from PSRCHIVE
(pplib.py:2697-2708,
``Integration.get_doppler_factor``/``get_parallactic_angle``); this
module computes them natively from the telescope's ITRF position, the
source coordinates (RAJ/DECJ in the stored ephemeris), and the subint
epochs:

* Earth's barycentric velocity from the exact Keplerian velocity of an
  elliptical orbit with low-precision mean solar elements (Meeus-style),
  plus the diurnal rotation velocity of the site.  The velocity (and
  GMST) are mean-of-date quantities, so catalog J2000 directions are
  precessed to date before projecting.  Error budget: neglected
  lunar/planetary terms ~15 m/s and residual frame effects (nutation
  ~17 arcsec) give |dbeta| <~ 1e-7, three orders below the annual 1e-4
  signal.
* doppler_factor = nu_source / nu_observed = sqrt((1+beta)/(1-beta)),
  beta = v/c > 0 for increasing distance (the convention documented at
  pplib.py:2697-2703).
* Parallactic angle from the hour angle at the site's geodetic
  latitude, in radians on (-pi, pi].

The ITRF coordinate table is public observatory-catalog data (TEMPO2
``observatories.dat``); entries cover the telescopes in
utils.telescopes that time pulsars.
"""

import re
import warnings

import numpy as np

__all__ = ["OBSERVATORY_ITRF", "gmst_rad", "itrf_to_geodetic",
           "parse_ra_dec", "earth_velocity_kms", "site_velocity_kms",
           "doppler_factor", "parallactic_angle",
           "doppler_parangle_for_archive"]

C_KMS = 299792.458
OMEGA_EARTH = 7.2921150e-5          # rad/s, Earth rotation rate
AU_KM = 1.495978707e8

# name -> ITRF (X, Y, Z) [m]; public TEMPO2 observatory catalog data.
OBSERVATORY_ITRF = {
    "GBT": (882589.65, -4924872.32, 3943729.348),
    "ARECIBO": (2390490.0, -5564764.0, 1994727.0),
    "PARKES": (-4554231.5, 2816759.1, -3454036.3),
    "JODRELL": (3822626.04, -154105.65, 5086486.04),
    "JB_MKII": (3822846.76, -153802.28, 5086285.90),
    "NANCAY": (4324165.81, 165927.11, 4670132.83),
    "NUPPI": (4324165.81, 165927.11, 4670132.83),
    "EFFELSBERG": (4033949.5, 486989.4, 4900430.8),
    "WSRT": (3828445.659, 445223.600, 5064921.568),
    "MEERKAT": (5109360.133, 2006852.586, -3238948.127),
    "FAST": (-1668557.0, 5506838.0, 2744934.0),
    "GMRT": (1656342.30, 5797947.77, 2073243.16),
    "VLA": (-1601192.0, -5041981.4, 3554871.4),
    "LOFAR": (3826577.462, 461022.624, 5064892.526),
    "SRT": (4865182.766, 791922.689, 4035137.174),
    "HARTEBEESTHOEK": (5085442.780, 2668263.483, -2768697.034),
    "MOST": (-4483311.64, 2648815.92, -3671909.31),
    "HOBART": (-3950077.96, 2522377.31, -4311667.52),
    "NANSHAN": (228310.702, 4631922.905, 4367064.059),
    "UAO": (228310.702, 4631922.905, 4367064.059),
    "CHIME": (-2059166.313, -3621302.972, 4814304.113),
    "LWA1": (-1602196.60, -5042313.47, 3553971.51),
    "GB140": (882872.57, -4924552.73, 3944154.92),
    "EFFELSBERG_ASTERIX": (4033949.5, 486989.4, 4900430.8),
}


# common aliases / TEMPO site names -> canonical table keys
_OBS_ALIASES = {
    "GREEN BANK": "GBT", "GB": "GBT", "NRT": "NANCAY",
    "JODRELL BANK": "JODRELL", "JB": "JODRELL", "AO": "ARECIBO",
    "PKS": "PARKES", "EFF": "EFFELSBERG", "MK": "MEERKAT",
    "NCY": "NANCAY", "NCYOBS": "NUPPI", "SARDINIA": "SRT",
}


def _obs_itrf(telescope):
    name = str(telescope).strip().upper()
    name = _OBS_ALIASES.get(name, name)
    itrf = OBSERVATORY_ITRF.get(name)
    if itrf is not None:
        return itrf
    # fall back to the alias lists in the telescope-code table
    from .telescopes import telescope_code_dict

    low = str(telescope).strip().lower()
    for canon, codes in telescope_code_dict.items():
        if low in [c.lower() for c in codes]:
            return OBSERVATORY_ITRF.get(
                _OBS_ALIASES.get(canon.upper(), canon.upper()))
    return None


def gmst_rad(mjd_ut):
    """Greenwich mean sidereal time [rad] (ERA-based linear model,
    adequate to <0.1 s over decades)."""
    d = np.asarray(mjd_ut, dtype=np.float64) - 51544.5
    gmst_hours = 18.697374558 + 24.06570982441908 * d
    return (gmst_hours % 24.0) * (2.0 * np.pi / 24.0)


def itrf_to_geodetic(xyz):
    """(lat_rad, lon_rad, height_m) from ITRF meters (Bowring's
    one-iteration method, WGS84)."""
    x, y, z = xyz
    a, f = 6378137.0, 1.0 / 298.257223563
    b = a * (1.0 - f)
    e2 = 1.0 - (b / a) ** 2
    ep2 = (a / b) ** 2 - 1.0
    p = np.hypot(x, y)
    theta = np.arctan2(z * a, p * b)
    lat = np.arctan2(z + ep2 * b * np.sin(theta) ** 3,
                     p - e2 * a * np.cos(theta) ** 3)
    lon = np.arctan2(y, x)
    N = a / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    h = p / np.cos(lat) - N
    return lat, lon, h


_RA_RE = re.compile(r"^\s*RAJ?\s+([\d:.+-]+)", re.MULTILINE)
_DEC_RE = re.compile(r"^\s*DECJ?\s+([\d:.+-]+)", re.MULTILINE)
_ELONG_RE = re.compile(r"^\s*(?:ELONG|LAMBDA)\s+([-+.\deE]+)",
                       re.MULTILINE)
_ELAT_RE = re.compile(r"^\s*(?:ELAT|BETA)\s+([-+.\deE]+)", re.MULTILINE)

# IAU 2006 obliquity at J2000, for ecliptic-coordinate ephemerides
_EPS0 = np.radians(84381.406 / 3600.0)


def _parse_sexagesimal(s):
    parts = [float(p) for p in s.split(":")]
    sign = -1.0 if s.strip().startswith("-") else 1.0
    mag = abs(parts[0]) + (parts[1] if len(parts) > 1 else 0.0) / 60.0 \
        + (parts[2] if len(parts) > 2 else 0.0) / 3600.0
    return sign * mag


def parse_ra_dec(ephemeris_text):
    """(ra_rad, dec_rad) J2000 from RAJ/DECJ — or ELONG/ELAT (ecliptic,
    the NANOGrav-style convention) — lines; None if neither present."""
    text = ephemeris_text or ""
    mra = _RA_RE.search(text)
    mdec = _DEC_RE.search(text)
    if mra and mdec:
        ra = _parse_sexagesimal(mra.group(1)) * (2.0 * np.pi / 24.0)
        dec = np.radians(_parse_sexagesimal(mdec.group(1)))
        return ra, dec
    mlon = _ELONG_RE.search(text)
    mlat = _ELAT_RE.search(text)
    if mlon and mlat:
        lam = np.radians(float(mlon.group(1)))
        bet = np.radians(float(mlat.group(1)))
        dec = np.arcsin(np.sin(bet) * np.cos(_EPS0)
                        + np.cos(bet) * np.sin(_EPS0) * np.sin(lam))
        ra = np.arctan2(np.sin(lam) * np.cos(_EPS0)
                        - np.tan(bet) * np.sin(_EPS0), np.cos(lam)) \
            % (2.0 * np.pi)
        return ra, dec
    return None


def precess_from_j2000(mjd, n_hat):
    """Rotate a J2000 unit vector to the mean equinox of date
    (IAU 1976 precession angles, first-order — arcsec-accurate over
    decades, ample for the 1e-4 Doppler signal)."""
    T = (np.asarray(mjd, dtype=np.float64).mean() - 51544.5) / 36525.0
    arcsec = np.pi / (180.0 * 3600.0)
    zeta = (2306.2181 * T + 0.30188 * T * T) * arcsec
    z = (2306.2181 * T + 1.09468 * T * T) * arcsec
    theta = (2004.3109 * T - 0.42665 * T * T) * arcsec

    def Rz(a):
        return np.array([[np.cos(a), np.sin(a), 0.0],
                         [-np.sin(a), np.cos(a), 0.0],
                         [0.0, 0.0, 1.0]])

    Ry = np.array([[np.cos(theta), 0.0, -np.sin(theta)],
                   [0.0, 1.0, 0.0],
                   [np.sin(theta), 0.0, np.cos(theta)]])
    return Rz(-z) @ Ry @ Rz(-zeta) @ np.asarray(n_hat)


def earth_velocity_kms(mjd):
    """Earth's barycentric velocity [km/s], equatorial J2000-of-date
    frame; exact Keplerian velocity on low-precision mean elements."""
    mjd = np.asarray(mjd, dtype=np.float64)
    T = (mjd - 51544.5) / 36525.0
    g = np.radians(357.52911 + 35999.05029 * T)       # solar mean anomaly
    L = np.radians(280.46646 + 36000.76983 * T)       # solar mean long.
    e = 0.016708634 - 0.000042037 * T
    C = np.radians((1.914602 - 0.004817 * T) * np.sin(g)
                   + (0.019993 - 0.000101 * T) * np.sin(2 * g)
                   + 0.000289 * np.sin(3 * g))        # equation of center
    lam_sun = L + C                                   # true solar long.
    pomega_sun = L - g                                # long. of perigee
    lam_e = lam_sun + np.pi                           # Earth helio long.
    pomega_e = pomega_sun + np.pi
    V = 2.0 * np.pi * AU_KM / (365.25636 * 86400.0) / np.sqrt(1.0 - e * e)
    vx_ecl = -V * (np.sin(lam_e) + e * np.sin(pomega_e))
    vy_ecl = V * (np.cos(lam_e) + e * np.cos(pomega_e))
    eps = np.radians(23.4392911 - 0.0130042 * T)
    return np.stack([vx_ecl,
                     vy_ecl * np.cos(eps),
                     vy_ecl * np.sin(eps)], axis=-1)


def site_velocity_kms(mjd, itrf_m):
    """Diurnal rotation velocity of an ITRF site [km/s], equatorial
    frame of date."""
    mjd = np.asarray(mjd, dtype=np.float64)
    theta = gmst_rad(mjd)
    x, y, z = np.asarray(itrf_m) / 1000.0
    # inertial position = Rz(theta) r; velocity = omega ez x position
    xi = x * np.cos(theta) - y * np.sin(theta)
    yi = x * np.sin(theta) + y * np.cos(theta)
    return OMEGA_EARTH * np.stack([-yi, xi, np.zeros_like(xi)], axis=-1)


def _n_hat_of_date(mjd, ra, dec):
    """Unit vector toward J2000 (ra, dec), precessed to the mean
    equinox of date (matching the of-date velocity/GMST frames)."""
    n_j2000 = np.array([np.cos(dec) * np.cos(ra),
                        np.cos(dec) * np.sin(ra), np.sin(dec)])
    return precess_from_j2000(mjd, n_j2000)


def doppler_factor(mjd, ra, dec, telescope="GBT"):
    """nu_source/nu_observed = sqrt((1+beta)/(1-beta)) toward J2000
    (ra, dec) [rad] at MJD(s); beta > 0 for increasing distance."""
    n_hat = _n_hat_of_date(mjd, ra, dec)
    v = earth_velocity_kms(mjd)
    itrf = _obs_itrf(telescope)
    if itrf is not None:
        v = v + site_velocity_kms(mjd, itrf)
    beta = -(v @ n_hat) / C_KMS           # receding -> beta > 0
    return np.sqrt((1.0 + beta) / (1.0 - beta))


def parallactic_angle(mjd, ra, dec, telescope="GBT"):
    """Parallactic angle [rad] at MJD(s) for a source at J2000
    (ra, dec)."""
    itrf = _obs_itrf(telescope)
    if itrf is None:
        return np.zeros_like(np.asarray(mjd, dtype=np.float64))
    nd = _n_hat_of_date(mjd, ra, dec)
    ra_d = np.arctan2(nd[1], nd[0])
    dec_d = np.arcsin(np.clip(nd[2], -1.0, 1.0))
    lat, lon, _ = itrf_to_geodetic(itrf)
    ha = gmst_rad(mjd) + lon - ra_d
    return np.arctan2(np.sin(ha),
                      np.tan(lat) * np.cos(dec_d)
                      - np.sin(dec_d) * np.cos(ha))


def doppler_parangle_for_archive(epochs, ephemeris_text, telescope,
                                 warn=True):
    """(doppler_factors [nsub], parallactic_angles [nsub]) for subint
    epochs, or (None, None) — with a loud warning, since downstream
    barycentric corrections silently degrade to topocentric — when the
    source coordinates or observatory position are unknown."""
    radec = parse_ra_dec(ephemeris_text)
    itrf_known = _obs_itrf(telescope) is not None
    if radec is None or not itrf_known:
        if warn and len(epochs):
            why = [] if radec is not None else \
                ["no RAJ/DECJ or ELONG/ELAT in the ephemeris"]
            if not itrf_known:
                why.append("telescope '%s' not in OBSERVATORY_ITRF"
                           % telescope)
            warnings.warn(
                "Cannot compute Doppler factors/parallactic angles (%s);"
                " falling back to unity/zero — barycentric (bary=True) "
                "DM/GM/tau outputs will actually be topocentric."
                % "; ".join(why), stacklevel=2)
        return None, None
    ra, dec = radec
    mjds = np.array([e.mjd() for e in epochs], dtype=np.float64)
    return (doppler_factor(mjds, ra, dec, telescope),
            parallactic_angle(mjds, ra, dec, telescope))
