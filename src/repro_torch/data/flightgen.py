"""Synthetic FLIGHTDELAY generator with planted causal ground truth — a
numpy copy of :mod:`repro.data.flightgen` whose tables land on a torch
device. Same seed, same arrays (``tests/test_torch_keys.py`` asserts it).

Reproduces the paper's experimental substrate (U.S. DOT flights joined to
Weather Underground observations) as a generative model whose *true* causal
effects are known — the generator materializes the full Neyman-Rubin table
(paper Table 2) including both potential outcomes Y(0), Y(1) per treatment,
so estimators can be scored on SATE recovery, not just eyeballed.

Planted structure (matching the paper's Example 2 narrative):
  - season (summer) raises BOTH thunderstorm probability AND traffic
    (confounding path  T <- season -> traffic -> delay);
  - pressure is lowered by storms but has ZERO causal effect on delay
    (the paper's low-pressure trap: maximally correlated, causally null);
  - true effects: thunder +30, low visibility +25, high wind +15, snow +40
    minutes, additively on the uncensored delay.

Schemas follow the paper's Table 1 (weather: visim/tempm/wspdm/pressurem/
precipm/thunder/hum/dewpoint per (airport, hour); flights: carrier, origin,
hour, traffic, delay, cancelled).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.data.columnar import Table
from repro_torch.device import DeviceLike

TRUE_EFFECTS = {
    "thunder": 30.0,
    "lowvis": 25.0,
    "highwind": 15.0,
    "snow": 40.0,
    "lowpressure": 0.0,   # the trap
}


@dataclasses.dataclass
class FlightData:
    weather: Table            # dimension table, one row per (airport, hour)
    flights: Table            # fact table (holds outcome + flight covariates)
    integrated: Table         # flights |><| weather (host-side join)
    true_sate: Dict[str, float]  # per-treatment sample ATE from counterfactuals
    n_airports: int
    n_carriers: int
    n_hours: int


def _weather(rng, n_airports: int, n_hours: int):
    hours = np.arange(n_hours)
    day = hours / 24.0
    season = 0.5 - 0.5 * np.cos(2 * np.pi * (day % 365.25) / 365.25)  # 0=winter
    season = np.broadcast_to(season, (n_airports, n_hours))
    apt_temp = rng.uniform(-5, 15, size=(n_airports, 1))

    storm = np.clip(rng.beta(0.6, 4.0, size=(n_airports, n_hours))
                    * (0.5 + 1.5 * season), 0, 1)
    fog = np.clip(rng.beta(0.7, 6.0, size=(n_airports, n_hours))
                  * (1.5 - season), 0, 1)

    tempm = apt_temp + 18 * season + rng.normal(0, 4, (n_airports, n_hours))
    thunder = (rng.random((n_airports, n_hours))
               < 0.01 + 0.25 * storm * season).astype(np.int32)
    wspdm = np.clip(8 + 45 * storm + rng.normal(0, 6, (n_airports, n_hours)),
                    0, None)
    precipm = np.clip(storm * rng.gamma(1.5, 0.6, (n_airports, n_hours))
                      - 0.1, 0, None)
    visim = np.clip(10 - 8.5 * fog - 4 * storm
                    + rng.normal(0, 1.2, (n_airports, n_hours)), 0.05, 10)
    # Low pressure: *caused by* storms, causally inert for delays.
    pressurem = 1015 - 9 * storm - 3 * season + rng.normal(
        0, 2, (n_airports, n_hours))
    hum = np.clip(45 + 40 * storm + 20 * fog
                  + rng.normal(0, 8, (n_airports, n_hours)), 5, 100)
    dewpoint = tempm - (100 - hum) / 5.0
    return dict(season=season, tempm=tempm, thunder=thunder, wspdm=wspdm,
                precipm=precipm, visim=visim, pressurem=pressurem, hum=hum,
                dewpoint=dewpoint)


def generate(n_flights: int = 20000, n_airports: int = 8, n_carriers: int = 6,
             n_days: int = 365, seed: int = 0,
             device: DeviceLike = None) -> FlightData:
    rng = np.random.default_rng(seed)
    n_hours = 24 * n_days
    w = _weather(rng, n_airports, n_hours)

    # ---- flights: seasonal + diurnal draw rates (summer = high season) ----
    hours = np.arange(n_hours)
    tod = hours % 24
    diurnal = np.clip(np.sin(np.pi * (tod - 5) / 18.0), 0.02, None)
    season_1d = 0.5 - 0.5 * np.cos(2 * np.pi * ((hours / 24.0) % 365.25)
                                   / 365.25)
    apt_pop = rng.uniform(0.5, 1.5, n_airports)
    rate = apt_pop[:, None] * diurnal[None, :] * (1.0 + 1.2 * season_1d)[None, :]
    p = (rate / rate.sum()).reshape(-1)
    cell = rng.choice(n_airports * n_hours, size=n_flights, p=p)
    f_apt = (cell // n_hours).astype(np.int32)
    f_hour = (cell % n_hours).astype(np.int32)
    f_carrier = rng.integers(0, n_carriers, n_flights).astype(np.int32)

    # traffic = #flights at same (airport, hour)  (paper's AirportTraffic)
    traffic_grid = np.zeros((n_airports, n_hours), np.int32)
    np.add.at(traffic_grid, (f_apt, f_hour), 1)
    f_traffic = traffic_grid[f_apt, f_hour].astype(np.float32)
    carrier_traffic = np.zeros((n_carriers, n_hours), np.int32)
    np.add.at(carrier_traffic, (f_carrier, f_hour), 1)
    f_carrier_traffic = carrier_traffic[f_carrier, f_hour].astype(np.float32)

    # ---- treatments (paper §5.1 definitions, incl. discard bands) --------
    gv = lambda name: w[name][f_apt, f_hour]
    thunder = gv("thunder").astype(np.int32)
    visim, wspdm, precipm, tempm, pressurem = (gv("visim"), gv("wspdm"),
                                               gv("precipm"), gv("tempm"),
                                               gv("pressurem"))
    lowvis = (visim < 1).astype(np.int32)
    lowvis_band = (visim >= 1) & (visim <= 5)          # discarded units
    highwind = (wspdm > 40).astype(np.int32)
    highwind_band = (wspdm >= 20) & (wspdm <= 40)
    snow = ((precipm > 0.3) & (tempm < 0)).astype(np.int32)
    lowpressure = (pressurem < 1008).astype(np.int32)

    # ---- potential outcomes (uncensored base + per-treatment effect) -----
    carrier_eff = rng.normal(0, 3, n_carriers)[f_carrier]
    apt_eff = rng.normal(0, 3, n_airports)[f_apt]
    noise = rng.normal(0, 10, n_flights)
    base = (6.0 + 0.9 * (f_traffic - f_traffic.mean())
            + 0.15 * (f_carrier_traffic - f_carrier_traffic.mean())
            + carrier_eff + apt_eff + noise)
    effects = (TRUE_EFFECTS["thunder"] * thunder
               + TRUE_EFFECTS["lowvis"] * lowvis
               + TRUE_EFFECTS["highwind"] * highwind
               + TRUE_EFFECTS["snow"] * snow)
    censor = lambda v: np.clip(v, 0, None).astype(np.float32)
    y_factual = censor(base + effects)

    treatments = dict(thunder=thunder, lowvis=lowvis, highwind=highwind,
                      snow=snow, lowpressure=lowpressure)
    true_sate = {}
    y0_cols, y1_cols = {}, {}
    for name, t in treatments.items():
        beta = TRUE_EFFECTS[name]
        y_others = base + effects - beta * t  # remove own effect
        y0 = censor(y_others)
        y1 = censor(y_others + beta)
        y0_cols[f"y0_{name}"] = y0
        y1_cols[f"y1_{name}"] = y1
        true_sate[name] = float(np.mean(y1 - y0))

    cancelled = (rng.random(n_flights)
                 < 0.004 + 0.04 * thunder + 0.05 * snow + 0.03 * lowvis
                 + 0.02 * highwind).astype(np.int32)

    weather_cols = {k: v.reshape(-1).astype(np.float32) if v.dtype != np.int32
                    else v.reshape(-1)
                    for k, v in w.items()}
    weather_cols["airport"] = np.repeat(np.arange(n_airports, dtype=np.int32),
                                        n_hours)
    weather_cols["hour"] = np.tile(np.arange(n_hours, dtype=np.int32),
                                   n_airports)
    weather = Table.from_numpy(weather_cols, device=device)

    flight_cols = dict(
        airport=f_apt, hour=f_hour, carrier=f_carrier,
        traffic=f_traffic, carrier_traffic=f_carrier_traffic,
        dep_delay=y_factual, cancelled=cancelled,
        lowvis_band=lowvis_band.astype(np.int32),
        highwind_band=highwind_band.astype(np.int32),
        **{k: v for k, v in treatments.items()},
        **y0_cols, **y1_cols,
    )
    flights = Table.from_numpy(flight_cols, device=device)

    int_cols = dict(flight_cols)
    for k, v in weather_cols.items():
        if k in ("airport", "hour"):
            continue
        int_cols[f"w_{k}"] = v.reshape(n_airports, n_hours)[f_apt, f_hour]
    integrated = Table.from_numpy(int_cols, device=device)

    return FlightData(weather=weather, flights=flights, integrated=integrated,
                      true_sate=true_sate, n_airports=n_airports,
                      n_carriers=n_carriers, n_hours=n_hours)


def treatment_valid_mask(data: FlightData, treatment: str) -> np.ndarray:
    """Paper §5.1: units inside the treatment's dead band are discarded."""
    t = data.integrated
    if treatment == "lowvis":
        return ~t["lowvis_band"].cpu().numpy().astype(bool)
    if treatment == "highwind":
        return ~t["highwind_band"].cpu().numpy().astype(bool)
    return np.ones(t.nrows, bool)
