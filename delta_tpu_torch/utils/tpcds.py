"""TPC-DS test data and query texts for the port's SQL.

A fixture generator, like `utils/synth.py`, not a benchmark: the port's
copy of the reference's SQL test data (`benchmarks/tpcds_data.py`) and of
the single-block texts of its query corpus (`benchmarks/tpcds_queries.py`).

- `generate(scale, seed)`: the numpy copy of `benchmarks/tpcds_data.py::
  generate` (`:451`), drawing the same values from the same seed, as
  `Batch`es (the card's machine has no Arrow). `scale` is the
  store_sales row count; every other table is sized by the generator's
  own rules (SF1's 2,880,404 store_sales rows give 11,521 items and
  57,608 customers). The money columns hold NaN values where the
  reference's do: it builds them with `pa.array` of float64, which keeps
  a NaN as a value, not a null. The reference's executor (data frames) and
  sqlite both read such a NaN as NULL, and so does the port's
  (`sqlengine/frame.py`).
- `load_delta(root, scale, seed, engine)`: every table written through
  `api.write_table` under `root/<name>` and registered in a `Catalog`.
- `QUERIES`: the 23 texts of the corpus that are one SELECT block (no
  WITH, subquery, set operation, window, outer join or ROLLUP), letter
  for letter.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from delta_tpu_torch.models.batch import Batch, Column

__all__ = ["generate", "load_delta", "TABLE_NAMES", "QUERIES"]


def _arr(x) -> Column:
    """The Column of what the reference passes to `pa.array`: an int or
    float ndarray, or a list of str (None a null)."""
    if isinstance(x, np.ndarray) and x.dtype != object:
        if x.dtype.kind in "iu":
            return Column(x.astype(np.int64))
        return Column(x.astype(np.float64))
    values = list(x)
    valid = np.fromiter((v is not None for v in values), bool, len(values))
    out = np.empty(len(values), object)
    out[:] = [v if v is not None else "" for v in values]
    return Column(out, None if valid.all() else valid)


def _dates(dates) -> Column:
    return Column(np.array(dates, dtype="datetime64[D]"))


def _table(cols: dict) -> Batch:
    return Batch(cols)


_CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Men",
               "Women", "Music", "Shoes", "Sports", "Children"]
# includes every i_class constant in the corpus (q53/q63/q89)
_CLASSES = ["accent", "bedding", "classical", "dresses", "football",
            "infants", "pants", "portable", "romance", "shirts",
            "personal", "reference", "self-help", "accessories",
            "fragrances", "pop", "home repair", "sports-apparel"]
# q53/q63 brand IN-lists; generic Brand#N fills the rest
_BRAND_POOL = ["scholaramalgamalg #14", "scholaramalgamalg #7",
               "exportiunivamalg #9", "scholaramalgamalg #9",
               "amalgimporto #1", "edu packscholar #1",
               "exportiimporto #1", "importoamalg #1"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_MARITAL = ["M", "S", "D", "W", "U"]
_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                  "0-500", "Unknown"]
_STORE_NAMES = ["ese", "ought", "able", "bar", "anti", "cally"]
_SM_TYPES = ["EXPRESS", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"]
_STATES = ["CA", "WA", "GA", "TX", "NY", "FL", "OH", "MI", "IL", "VA",
           "TN", "NE", "IA", "IN", "KY", "AL", "MN", "SD"]
_COUNTIES = ["Williamson County", "Ziebach County", "Walker County",
             "Daviess County", "Fairfield County", "Barrow County",
             "Franklin Parish", "Luce County", "Mobile County"]
_CITIES = ["Midway", "Fairview", "Oakland", "Pleasant Hill", "Centerville",
           "Five Points", "Liberty", "Bethel", "Summit"]
_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday"]
# pools guarantee the corpus' IN-list / equality constants exist
_MANUFACT_POOL = [816, 928, 715, 942, 861, 941, 920, 105, 693]

TABLE_NAMES = [
    "date_dim", "time_dim", "item", "customer", "customer_address",
    "customer_demographics", "household_demographics", "promotion",
    "store", "warehouse", "ship_mode", "web_site", "web_page",
    "catalog_page", "call_center", "reason", "income_band",
    "store_sales", "store_returns", "catalog_sales",
    "catalog_returns", "web_sales", "web_returns", "inventory",
]

_BASE_DATE = datetime.date(1998, 1, 1)
_N_DAYS = 5 * 366  # 1998-01-01 .. 2002-12-31 and a bit

_DATE_SK0 = 2450000  # julian-ish offset like dsdgen's


def _money(rng, n, lo=1.0, hi=300.0, null_frac=0.02):
    # NaN values, not nulls: the reference builds these with `pa.array`
    # of float64, so a NaN stays a value
    v = np.round(rng.uniform(lo, hi, n), 2)
    if null_frac:
        v[rng.random(n) < null_frac] = np.nan
    return Column(v)


def _maybe_null_int(rng, vals, null_frac=0.02):
    mask = rng.random(len(vals)) < null_frac
    if mask.any():
        return Column(np.where(mask, 0, vals).astype(np.int64), ~mask)
    return Column(vals.astype(np.int64))


def _date_dim() -> Batch:
    days = np.arange(_N_DAYS)
    dates = [_BASE_DATE + datetime.timedelta(days=int(i)) for i in days]
    years = np.array([d.year for d in dates], dtype=np.int64)
    months = np.array([d.month for d in dates], dtype=np.int64)
    return _table({
        "d_date_sk": _arr(_DATE_SK0 + days),
        "d_date": _dates(dates),
        "d_year": _arr(years),
        "d_moy": _arr(months),
        "d_dom": _arr(np.array([d.day for d in dates], np.int64)),
        "d_qoy": _arr((months - 1) // 3 + 1),
        # (year-1900)*12 + month-1: 1998-07=1182 .. 2002-09=1232 covers
        # every d_month_seq window in the corpus (1186..1232)
        "d_month_seq": _arr((years - 1900) * 12 + months - 1),
        "d_week_seq": _arr((days // 7) + 5100),
        "d_quarter_name": _arr(
            [f"{d.year}Q{(d.month - 1) // 3 + 1}" for d in dates]),
        "d_day_name": _arr(
            [_DAY_NAMES[d.weekday() if d.weekday() != 6 else 6]
             for d in dates]),
        "d_dow": _arr(np.array(
            [(d.weekday() + 1) % 7 for d in dates], np.int64)),
    })


def _time_dim() -> Batch:
    mins = np.arange(24 * 60)
    hours = mins // 60
    meal = np.where(hours < 9, "breakfast",
                    np.where((hours >= 11) & (hours < 14), "lunch",
                             np.where((hours >= 17) & (hours < 21),
                                      "dinner", None)))
    return _table({
        "t_time_sk": _arr(mins * 60),  # sk = second of day
        "t_time": _arr(mins * 60),
        "t_hour": _arr(hours),
        "t_minute": _arr(mins % 60),
        "t_meal_time": _arr(meal.tolist()),
    })


def _item(rng, n_items) -> Batch:
    sk = np.arange(1, n_items + 1)
    manufact = np.where(
        rng.random(n_items) < 0.3,
        rng.choice(_MANUFACT_POOL, n_items),
        rng.integers(1, 1000, n_items))
    brand_id = rng.integers(1, 500, n_items)
    cat_id = rng.integers(1, len(_CATEGORIES) + 1, n_items)
    return _table({
        "i_item_sk": _arr(sk),
        "i_item_id": _arr([f"AAAAAAAA{j:08d}" for j in sk]),
        "i_item_desc": _arr([f"item description {j % 97}"
                                 for j in sk]),
        "i_brand_id": _arr(brand_id),
        "i_brand": _arr(
            [_BRAND_POOL[j % len(_BRAND_POOL)] if j % 4 == 0
             else f"Brand#{b}"
             for j, b in zip(sk, brand_id)]),
        "i_class_id": _arr(rng.integers(1, 11, n_items)),
        "i_class": _arr([_CLASSES[c] for c in
                             rng.integers(0, len(_CLASSES), n_items)]),
        "i_category_id": _arr(cat_id),
        "i_category": _arr([_CATEGORIES[c - 1] for c in cat_id]),
        "i_manufact_id": _arr(manufact.astype(np.int64)),
        "i_manufact": _arr([f"manufact#{m}" for m in manufact]),
        # deterministic cycle: every manager id 1..100 owns items, so
        # the corpus' i_manager_id = 1/26/87 filters always match
        "i_manager_id": _arr((sk - 1) % 100 + 1),
        "i_current_price": _arr(
            np.round(rng.uniform(1.0, 120.0, n_items), 2)),
        "i_wholesale_cost": _arr(
            np.round(rng.uniform(1.0, 80.0, n_items), 2)),
        "i_product_name": _arr(
            [f"product {j % 211}ought" for j in sk]),
        "i_color": _arr(
            [["slate", "blanched", "burnished", "peach", "metallic",
              "dim", "red", "navy"][c]
             for c in rng.integers(0, 8, n_items)]),
        "i_size": _arr(
            [["small", "medium", "large", "petite", "extra large",
              "economy", "N/A"][c] for c in rng.integers(0, 7, n_items)]),
        "i_units": _arr(
            [["Each", "Dozen", "Case", "Pallet", "Oz", "Lb"][c]
             for c in rng.integers(0, 6, n_items)]),
    })


def _customer(rng, n_cust, n_addr) -> Batch:
    sk = np.arange(1, n_cust + 1)
    first = ["James", "Mary", "John", "Linda", "Robert", "Ann",
             "Michael", "Susan"]
    last = ["Smith", "Jones", "Brown", "Lee", "Garcia", "Miller",
            "Davis", "Moore"]
    return _table({
        "c_customer_sk": _arr(sk),
        "c_customer_id": _arr([f"CUST{j:012d}" for j in sk]),
        "c_current_addr_sk": _arr(
            rng.integers(1, n_addr + 1, n_cust)),
        "c_current_cdemo_sk": _arr(rng.integers(1, 71, n_cust)),
        "c_current_hdemo_sk": _arr(rng.integers(1, 301, n_cust)),
        "c_first_name": _arr(
            [first[i] for i in rng.integers(0, len(first), n_cust)]),
        "c_last_name": _arr(
            [last[i] for i in rng.integers(0, len(last), n_cust)]),
        "c_salutation": _arr(
            [["Mr.", "Ms.", "Dr."][i]
             for i in rng.integers(0, 3, n_cust)]),
        "c_preferred_cust_flag": _arr(
            [["Y", "N"][i] for i in rng.integers(0, 2, n_cust)]),
        "c_birth_country": _arr(
            [["UNITED STATES", "CANADA", "MEXICO"][i]
             for i in rng.integers(0, 3, n_cust)]),
        "c_birth_day": _arr(
            rng.integers(1, 29, n_cust).astype(np.int64)),
        "c_birth_month": _arr(
            rng.integers(1, 13, n_cust).astype(np.int64)),
        "c_birth_year": _arr(
            rng.integers(1930, 1995, n_cust).astype(np.int64)),
        "c_login": _arr([f"user{j}" for j in sk]),
        "c_email_address": _arr(
            [f"user{j}@example.com" for j in sk]),
        "c_last_review_date": _arr(
            (_DATE_SK0 + rng.integers(0, _N_DAYS, n_cust)).astype(
                np.int64)),
        "c_first_sales_date_sk": _arr(
            (_DATE_SK0 + rng.integers(0, _N_DAYS, n_cust)).astype(
                np.int64)),
        "c_first_shipto_date_sk": _arr(
            (_DATE_SK0 + rng.integers(0, _N_DAYS, n_cust)).astype(
                np.int64)),
    })


def _customer_address(rng, n_addr) -> Batch:
    sk = np.arange(1, n_addr + 1)
    zips = np.where(rng.random(n_addr) < 0.1,
                    rng.choice([85669, 86197, 88274, 83405, 86475,
                                85392, 85460, 80348, 81792], n_addr),
                    rng.integers(10000, 99999, n_addr))
    return _table({
        "ca_address_sk": _arr(sk),
        "ca_zip": _arr([f"{z:05d}" for z in zips]),
        "ca_state": _arr(
            [_STATES[i] for i in rng.integers(0, len(_STATES), n_addr)]),
        "ca_city": _arr(
            [_CITIES[i] for i in rng.integers(0, len(_CITIES), n_addr)]),
        "ca_county": _arr(
            [_COUNTIES[i]
             for i in rng.integers(0, len(_COUNTIES), n_addr)]),
        "ca_country": _arr(["United States"] * n_addr),
        "ca_street_number": _arr(
            [str(z) for z in rng.integers(1, 1000, n_addr)]),
        "ca_street_name": _arr(
            [["Main", "Oak", "Park", "First"][i]
             for i in rng.integers(0, 4, n_addr)]),
        "ca_street_type": _arr(
            [["St", "Ave", "Blvd", "Ln"][i]
             for i in rng.integers(0, 4, n_addr)]),
        "ca_suite_number": _arr(
            [f"Suite {z}" for z in rng.integers(0, 500, n_addr)]),
        "ca_gmt_offset": _arr(
            np.where(rng.random(n_addr) < 0.5, -6.0, -5.0)),
        "ca_location_type": _arr(
            [["apartment", "condo", "single family"][i]
             for i in rng.integers(0, 3, n_addr)]),
    })


def _customer_demographics() -> Batch:
    rows = [(g, m, e)
            for g in ("M", "F")
            for m in _MARITAL
            for e in _EDUCATION]
    return _table({
        "cd_demo_sk": _arr(np.arange(1, len(rows) + 1)),
        "cd_gender": _arr([r[0] for r in rows]),
        "cd_marital_status": _arr([r[1] for r in rows]),
        "cd_education_status": _arr([r[2] for r in rows]),
        "cd_dep_count": _arr(
            np.arange(len(rows), dtype=np.int64) % 7),
        "cd_dep_employed_count": _arr(
            np.arange(len(rows), dtype=np.int64) % 5),
        "cd_dep_college_count": _arr(
            np.arange(len(rows), dtype=np.int64) % 4),
        "cd_purchase_estimate": _arr(
            (np.arange(len(rows), dtype=np.int64) % 12) * 500 + 500),
        "cd_credit_rating": _arr(
            [["Low Risk", "High Risk", "Good", "Unknown"][j % 4]
             for j in range(len(rows))]),
    })


def _household_demographics() -> Batch:
    rows = [(d, v, b)
            for d in range(10)
            for v in range(5)
            for b in _BUY_POTENTIAL]
    return _table({
        "hd_demo_sk": _arr(np.arange(1, len(rows) + 1)),
        "hd_dep_count": _arr(np.array([r[0] for r in rows],
                                          np.int64)),
        "hd_vehicle_count": _arr(np.array([r[1] for r in rows],
                                              np.int64)),
        "hd_buy_potential": _arr([r[2] for r in rows]),
        "hd_income_band_sk": _arr(
            np.arange(len(rows), dtype=np.int64) % 20 + 1),
    })


def _promotion(rng) -> Batch:
    n = 30
    return _table({
        "p_promo_sk": _arr(np.arange(1, n + 1)),
        "p_channel_email": _arr(
            [["N", "Y"][i] for i in rng.integers(0, 2, n)]),
        "p_channel_event": _arr(
            [["N", "Y"][i] for i in rng.integers(0, 2, n)]),
        "p_channel_dmail": _arr(
            [["N", "Y"][i] for i in rng.integers(0, 2, n)]),
        "p_channel_tv": _arr(
            [["N", "Y"][i] for i in rng.integers(0, 2, n)]),
    })


def _store(rng) -> Batch:
    n = 12
    sk = np.arange(1, n + 1)
    return _table({
        "s_store_sk": _arr(sk),
        "s_store_id": _arr([f"STORE{j:010d}" for j in sk]),
        "s_store_name": _arr(
            [_STORE_NAMES[j % len(_STORE_NAMES)] for j in sk]),
        "s_gmt_offset": _arr(
            np.where(sk % 2 == 0, -6.0, -5.0)),
        "s_zip": _arr([f"{z:05d}" for z in
                           rng.integers(10000, 99999, n)]),
        "s_city": _arr(
            [_CITIES[i] for i in rng.integers(0, len(_CITIES), n)]),
        "s_county": _arr(
            [_COUNTIES[i] for i in rng.integers(0, len(_COUNTIES), n)]),
        "s_state": _arr(
            [_STATES[j % len(_STATES)] for j in range(n)]),
        "s_number_employees": _arr(
            rng.integers(200, 301, n).astype(np.int64)),
        "s_market_id": _arr(
            rng.integers(1, 11, n).astype(np.int64)),
        "s_company_id": _arr(np.ones(n, np.int64)),
        "s_company_name": _arr(["Unknown"] * n),
        "s_street_number": _arr(
            [str(z) for z in rng.integers(1, 1000, n)]),
        "s_street_name": _arr(
            [["Main", "Oak", "Park", "First"][i]
             for i in rng.integers(0, 4, n)]),
        "s_street_type": _arr(
            [["St", "Ave", "Blvd", "Ln"][i]
             for i in rng.integers(0, 4, n)]),
        "s_suite_number": _arr(
            [f"Suite {z}" for z in rng.integers(0, 500, n)]),
    })


def _warehouse(rng) -> Batch:
    n = 5
    return _table({
        "w_warehouse_sk": _arr(np.arange(1, n + 1)),
        "w_warehouse_name": _arr(
            [f"Warehouse number {j} of the chain" for j in range(n)]),
        "w_warehouse_sq_ft": _arr(
            rng.integers(50_000, 1_000_000, n).astype(np.int64)),
        "w_city": _arr(
            [_CITIES[i] for i in rng.integers(0, len(_CITIES), n)]),
        "w_county": _arr(
            [_COUNTIES[i] for i in rng.integers(0, len(_COUNTIES), n)]),
        "w_state": _arr(
            [_STATES[i] for i in rng.integers(0, len(_STATES), n)]),
        "w_country": _arr(["United States"] * n),
    })


def _ship_mode() -> Batch:
    n = len(_SM_TYPES) * 4
    return _table({
        "sm_ship_mode_sk": _arr(np.arange(1, n + 1)),
        "sm_type": _arr([_SM_TYPES[j % len(_SM_TYPES)]
                             for j in range(n)]),
        "sm_carrier": _arr(
            [["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL"][j % 5]
             for j in range(n)]),
    })


def _web_site() -> Batch:
    n = 6
    return _table({
        "web_site_sk": _arr(np.arange(1, n + 1)),
        "web_site_id": _arr([f"SITE{j:012d}" for j in range(n)]),
        "web_name": _arr([f"site_{j}" for j in range(n)]),
        "web_company_name": _arr(["pri"] * n),
    })


def _web_page(rng) -> Batch:
    n = 60
    return _table({
        "wp_web_page_sk": _arr(np.arange(1, n + 1)),
        "wp_char_count": _arr(
            rng.integers(4000, 6000, n).astype(np.int64)),
    })


def _reason() -> Batch:
    n = 9
    sk = np.arange(1, n + 1)
    descs = ["Package was damaged", "Stopped working", "Did not get it",
             "Not the product that was ordred", "Parts missing",
             "Does not work with a product that I have",
             "Gift exchange", "Did not like the color",
             "Did not like the model"]
    return _table({
        "r_reason_sk": _arr(sk),
        "r_reason_desc": _arr(descs),
    })


def _income_band() -> Batch:
    n = 20
    sk = np.arange(1, n + 1)
    return _table({
        "ib_income_band_sk": _arr(sk),
        "ib_lower_bound": _arr((sk - 1) * 10000),
        "ib_upper_bound": _arr(sk * 10000),
    })


def _catalog_page() -> Batch:
    n = 20
    sk = np.arange(1, n + 1)
    return _table({
        "cp_catalog_page_sk": _arr(sk),
        "cp_catalog_page_id": _arr(
            [f"PAGE{j:012d}" for j in sk]),
    })


def _call_center() -> Batch:
    n = 4
    return _table({
        "cc_call_center_sk": _arr(np.arange(1, n + 1)),
        "cc_call_center_id": _arr(
            [f"CC{j:014d}" for j in range(n)]),
        "cc_name": _arr([f"call center {j}" for j in range(n)]),
        "cc_manager": _arr([f"Manager {j}" for j in range(n)]),
        "cc_county": _arr(
            [_COUNTIES[j % len(_COUNTIES)] for j in range(n)]),
    })


def generate(scale: int = 50_000, seed: int = 7):
    """{table_name: Batch} for every table, the reference's values
    from the same seed; `scale` = the store_sales row count."""
    rng = np.random.default_rng(seed)
    n_items = max(200, scale // 250)
    n_cust = max(500, scale // 50)
    n_addr = n_cust

    tables = {
        "date_dim": _date_dim(),
        "time_dim": _time_dim(),
        "item": _item(rng, n_items),
        "customer": _customer(rng, n_cust, n_addr),
        "customer_address": _customer_address(rng, n_addr),
        "customer_demographics": _customer_demographics(),
        "household_demographics": _household_demographics(),
        "promotion": _promotion(rng),
        "store": _store(rng),
        "warehouse": _warehouse(rng),
        "ship_mode": _ship_mode(),
        "web_site": _web_site(),
        "web_page": _web_page(rng),
        "catalog_page": _catalog_page(),
        "call_center": _call_center(),
        "reason": _reason(),
        "income_band": _income_band(),
    }

    n_cd = tables["customer_demographics"].num_rows
    n_hd = tables["household_demographics"].num_rows
    n_store = tables["store"].num_rows
    n_wh = tables["warehouse"].num_rows
    n_sm = tables["ship_mode"].num_rows
    n_ws_site = tables["web_site"].num_rows
    n_wp = tables["web_page"].num_rows
    n_cc = tables["call_center"].num_rows
    time_sks = tables["time_dim"].column("t_time_sk").values

    # ---- store_sales --------------------------------------------------
    # ticket-structured: a ticket is one basket — same customer, store,
    # date, time, demographics for all its line items (the reference's
    # dsdgen does the same); ticket sizes 1..25 so the q34/q73
    # `cnt between 15 and 20` shapes have matches
    n = scale
    t_sizes = rng.integers(1, 26, n)
    ticket_of_row = np.repeat(np.arange(n), t_sizes)[:n]
    n_tickets = int(ticket_of_row[-1]) + 1
    t_day = rng.integers(0, _N_DAYS, n_tickets)
    t_time = rng.choice(time_sks, n_tickets).astype(np.int64)
    t_cust = rng.integers(1, n_cust + 1, n_tickets)
    t_cdemo = rng.integers(1, n_cd + 1, n_tickets)
    t_hdemo = rng.integers(1, n_hd + 1, n_tickets)
    t_addr = rng.integers(1, n_addr + 1, n_tickets)
    t_store = rng.integers(1, n_store + 1, n_tickets)
    sold_day = t_day[ticket_of_row]
    qty = rng.integers(1, 101, n).astype(np.int64)
    sales_price = np.round(rng.uniform(1.0, 200.0, n), 2)
    tables["store_sales"] = _table({
        "ss_sold_date_sk": _maybe_null_int(rng, _DATE_SK0 + sold_day,
                                           0.01),
        "ss_sold_time_sk": _arr(t_time[ticket_of_row]),
        "ss_item_sk": _arr(
            rng.integers(1, n_items + 1, n).astype(np.int64)),
        "ss_customer_sk": _arr(
            t_cust[ticket_of_row].astype(np.int64)),
        "ss_cdemo_sk": _maybe_null_int(
            rng, t_cdemo[ticket_of_row], 0.03),
        "ss_hdemo_sk": _arr(
            t_hdemo[ticket_of_row].astype(np.int64)),
        "ss_addr_sk": _maybe_null_int(
            rng, t_addr[ticket_of_row], 0.03),
        "ss_store_sk": _arr(
            t_store[ticket_of_row].astype(np.int64)),
        "ss_promo_sk": _maybe_null_int(
            rng, rng.integers(1, 31, n), 0.05),
        "ss_ticket_number": _arr(
            (ticket_of_row + 1).astype(np.int64)),
        "ss_quantity": _arr(qty),
        "ss_list_price": _money(rng, n, 1, 250),
        "ss_sales_price": _arr(sales_price),
        "ss_ext_sales_price": _money(rng, n, 1, 2000),
        "ss_ext_discount_amt": _money(rng, n, 0, 100),
        "ss_ext_list_price": _money(rng, n, 1, 2500),
        "ss_ext_wholesale_cost": _money(rng, n, 1, 1500),
        "ss_ext_tax": _money(rng, n, 0, 150),
        "ss_coupon_amt": _money(rng, n, 0, 50),
        "ss_net_paid": _money(rng, n, 1, 2000),
        "ss_net_paid_inc_tax": _money(rng, n, 1, 2100),
        "ss_net_profit": _arr(
            np.round(rng.uniform(-5000.0, 5000.0, n), 2)),
        "ss_wholesale_cost": _money(rng, n, 1, 100),
    })

    # ---- store_returns (sampled from sales, so the
    # customer+item+ticket join chain of q17/q25/q29/q50 has matches) --
    nr = max(100, scale // 8)
    ret_idx = rng.integers(0, n, nr)
    ss_item = tables["store_sales"].column("ss_item_sk").values
    ret_day = np.minimum(sold_day[ret_idx] + rng.integers(1, 100, nr),
                         _N_DAYS - 1)
    tables["store_returns"] = _table({
        "sr_returned_date_sk": _arr(
            (_DATE_SK0 + ret_day).astype(np.int64)),
        "sr_item_sk": _arr(ss_item[ret_idx]),
        "sr_customer_sk": _arr(
            t_cust[ticket_of_row[ret_idx]].astype(np.int64)),
        "sr_cdemo_sk": _arr(
            t_cdemo[ticket_of_row[ret_idx]].astype(np.int64)),
        "sr_store_sk": _arr(
            t_store[ticket_of_row[ret_idx]].astype(np.int64)),
        "sr_ticket_number": _arr(
            (ticket_of_row[ret_idx] + 1).astype(np.int64)),
        "sr_reason_sk": _arr(
            rng.integers(1, 10, nr).astype(np.int64)),
        "sr_return_quantity": _arr(
            rng.integers(1, 50, nr).astype(np.int64)),
        "sr_return_amt": _money(rng, nr, 1, 500),
        "sr_fee": _money(rng, nr, 1, 100),
        "sr_net_loss": _money(rng, nr, 1, 300),
    })

    # ---- catalog_sales ------------------------------------------------
    nc = max(200, scale // 2)
    c_sold = rng.integers(0, _N_DAYS, nc)
    # ~40% of catalog orders come from customers re-buying a returned
    # item: feeds the sr→cs leg of the q17/q25/q29 triple join
    sr_cust = tables["store_returns"].column(
        "sr_customer_sk").values
    sr_item = tables["store_returns"].column("sr_item_sk").values
    pick = rng.integers(0, nr, nc)
    reuse = rng.random(nc) < 0.4
    cs_cust = np.where(reuse, sr_cust[pick],
                       rng.integers(1, n_cust + 1, nc))
    cs_item = np.where(reuse, sr_item[pick],
                       rng.integers(1, n_items + 1, nc))
    tables["catalog_sales"] = _table({
        "cs_sold_date_sk": _maybe_null_int(rng, _DATE_SK0 + c_sold,
                                           0.01),
        "cs_sold_time_sk": _arr(
            rng.choice(time_sks, nc).astype(np.int64)),
        "cs_ship_date_sk": _arr(
            (_DATE_SK0 + np.minimum(c_sold + rng.integers(1, 140, nc),
                                    _N_DAYS - 1)).astype(np.int64)),
        "cs_item_sk": _arr(cs_item.astype(np.int64)),
        "cs_bill_customer_sk": _arr(cs_cust.astype(np.int64)),
        "cs_bill_cdemo_sk": _arr(
            rng.integers(1, n_cd + 1, nc).astype(np.int64)),
        "cs_bill_hdemo_sk": _arr(
            rng.integers(1, n_hd + 1, nc).astype(np.int64)),
        "cs_bill_addr_sk": _arr(
            rng.integers(1, n_addr + 1, nc).astype(np.int64)),
        "cs_ship_customer_sk": _maybe_null_int(
            rng, rng.integers(1, n_cust + 1, nc), 0.03),
        "cs_ship_addr_sk": _arr(
            rng.integers(1, n_addr + 1, nc).astype(np.int64)),
        "cs_ship_mode_sk": _arr(
            rng.integers(1, n_sm + 1, nc).astype(np.int64)),
        "cs_warehouse_sk": _maybe_null_int(
            rng, rng.integers(1, n_wh + 1, nc), 0.03),
        "cs_call_center_sk": _arr(
            rng.integers(1, n_cc + 1, nc).astype(np.int64)),
        "cs_promo_sk": _maybe_null_int(
            rng, rng.integers(1, 31, nc), 0.05),
        "cs_catalog_page_sk": _maybe_null_int(
            rng, rng.integers(1, 21, nc), 0.03),
        "cs_order_number": _arr((np.arange(nc) // 2 + 1)),
        "cs_quantity": _arr(rng.integers(1, 101, nc).astype(
            np.int64)),
        "cs_list_price": _money(rng, nc, 1, 250),
        "cs_sales_price": _money(rng, nc, 1, 600, null_frac=0.0),
        "cs_ext_sales_price": _money(rng, nc, 1, 2000),
        "cs_coupon_amt": _money(rng, nc, 0, 50),
        "cs_ext_discount_amt": _money(rng, nc, 0, 100),
        "cs_ext_ship_cost": _money(rng, nc, 0, 100),
        "cs_ext_list_price": _money(rng, nc, 1, 2500),
        "cs_ext_wholesale_cost": _money(rng, nc, 1, 1500),
        "cs_net_paid": _money(rng, nc, 1, 2000),
        "cs_net_paid_inc_ship": _money(rng, nc, 1, 2100),
        "cs_net_paid_inc_ship_tax": _money(rng, nc, 1, 2200),
        "cs_wholesale_cost": _money(rng, nc, 1, 100),
        "cs_net_profit": _arr(
            np.round(rng.uniform(-4000.0, 4000.0, nc), 2)),
    })

    # ---- catalog_returns (sampled from catalog_sales) -----------------
    ncr = max(100, nc // 8)
    cr_idx = rng.integers(0, nc, ncr)
    cs_item_np = tables["catalog_sales"].column("cs_item_sk").values
    cs_ono_np = tables["catalog_sales"].column(
        "cs_order_number").values
    cr_day = np.minimum(c_sold[cr_idx] + rng.integers(1, 100, ncr),
                        _N_DAYS - 1)
    tables["catalog_returns"] = _table({
        "cr_returned_date_sk": _arr(
            (_DATE_SK0 + cr_day).astype(np.int64)),
        "cr_item_sk": _arr(cs_item_np[cr_idx]),
        "cr_order_number": _arr(cs_ono_np[cr_idx]),
        "cr_returning_customer_sk": _arr(
            cs_cust[cr_idx].astype(np.int64)),
        "cr_returning_addr_sk": _arr(
            rng.integers(1, n_addr + 1, ncr).astype(np.int64)),
        "cr_call_center_sk": _arr(
            rng.integers(1, n_cc + 1, ncr).astype(np.int64)),
        "cr_catalog_page_sk": _arr(
            rng.integers(1, 21, ncr).astype(np.int64)),
        "cr_return_quantity": _arr(
            rng.integers(1, 50, ncr).astype(np.int64)),
        "cr_return_amount": _money(rng, ncr, 1, 500),
        "cr_return_amt_inc_tax": _money(rng, ncr, 1, 550),
        "cr_refunded_cash": _money(rng, ncr, 0, 400),
        "cr_reversed_charge": _money(rng, ncr, 0, 100),
        "cr_store_credit": _money(rng, ncr, 0, 100),
        "cr_net_loss": _money(rng, ncr, 1, 300),
    })

    # ---- web_sales ----------------------------------------------------
    nw = max(200, scale // 2)
    w_sold = rng.integers(0, _N_DAYS, nw)
    tables["web_sales"] = _table({
        "ws_sold_date_sk": _maybe_null_int(rng, _DATE_SK0 + w_sold,
                                           0.01),
        "ws_sold_time_sk": _arr(
            rng.choice(time_sks, nw).astype(np.int64)),
        "ws_ship_date_sk": _arr(
            (_DATE_SK0 + np.minimum(w_sold + rng.integers(1, 140, nw),
                                    _N_DAYS - 1)).astype(np.int64)),
        "ws_item_sk": _arr(
            rng.integers(1, n_items + 1, nw).astype(np.int64)),
        "ws_bill_customer_sk": _arr(
            rng.integers(1, n_cust + 1, nw).astype(np.int64)),
        "ws_bill_addr_sk": _arr(
            rng.integers(1, n_addr + 1, nw).astype(np.int64)),
        "ws_ship_customer_sk": _arr(
            rng.integers(1, n_cust + 1, nw).astype(np.int64)),
        "ws_ship_hdemo_sk": _maybe_null_int(
            rng, rng.integers(1, n_hd + 1, nw), 0.03),
        "ws_ship_addr_sk": _arr(
            rng.integers(1, n_addr + 1, nw).astype(np.int64)),
        "ws_ship_mode_sk": _arr(
            rng.integers(1, n_sm + 1, nw).astype(np.int64)),
        "ws_warehouse_sk": _arr(
            rng.integers(1, n_wh + 1, nw).astype(np.int64)),
        "ws_web_site_sk": _arr(
            rng.integers(1, n_ws_site + 1, nw).astype(np.int64)),
        "ws_web_page_sk": _maybe_null_int(
            rng, rng.integers(1, n_wp + 1, nw), 0.03),
        "ws_promo_sk": _maybe_null_int(
            rng, rng.integers(1, 31, nw), 0.05),
        "ws_order_number": _arr((np.arange(nw) // 2 + 1)),
        "ws_quantity": _arr(rng.integers(1, 101, nw).astype(
            np.int64)),
        "ws_list_price": _money(rng, nw, 1, 250),
        "ws_sales_price": _money(rng, nw, 1, 600, null_frac=0.0),
        "ws_ext_sales_price": _money(rng, nw, 1, 2000),
        "ws_ext_ship_cost": _money(rng, nw, 0, 100),
        "ws_ext_discount_amt": _money(rng, nw, 0, 100),
        "ws_ext_list_price": _money(rng, nw, 1, 2500),
        "ws_ext_wholesale_cost": _money(rng, nw, 1, 1500),
        "ws_wholesale_cost": _money(rng, nw, 1, 100),
        "ws_net_paid": _money(rng, nw, 1, 2000),
        "ws_net_paid_inc_tax": _money(rng, nw, 1, 2100),
        "ws_net_profit": _arr(
            np.round(rng.uniform(-4000.0, 4000.0, nw), 2)),
    })

    # ---- web_returns (sampled from web_sales) -------------------------
    nwr = max(100, nw // 8)
    wr_idx = rng.integers(0, nw, nwr)
    ws_item_np = tables["web_sales"].column("ws_item_sk").values
    ws_ono_np = tables["web_sales"].column("ws_order_number").values
    ws_cust_np = tables["web_sales"].column(
        "ws_bill_customer_sk").values
    wr_day = np.minimum(w_sold[wr_idx] + rng.integers(1, 100, nwr),
                        _N_DAYS - 1)
    tables["web_returns"] = _table({
        "wr_returned_date_sk": _arr(
            (_DATE_SK0 + wr_day).astype(np.int64)),
        "wr_item_sk": _arr(ws_item_np[wr_idx]),
        "wr_order_number": _arr(ws_ono_np[wr_idx]),
        "wr_returning_customer_sk": _arr(ws_cust_np[wr_idx]),
        "wr_refunded_cdemo_sk": _arr(
            rng.integers(1, n_cd + 1, nwr).astype(np.int64)),
        "wr_returning_cdemo_sk": _arr(
            rng.integers(1, n_cd + 1, nwr).astype(np.int64)),
        "wr_refunded_addr_sk": _arr(
            rng.integers(1, n_addr + 1, nwr).astype(np.int64)),
        "wr_returning_addr_sk": _arr(
            rng.integers(1, n_addr + 1, nwr).astype(np.int64)),
        "wr_web_page_sk": _arr(
            rng.integers(1, n_wp + 1, nwr).astype(np.int64)),
        "wr_reason_sk": _arr(
            rng.integers(1, 10, nwr).astype(np.int64)),
        "wr_return_quantity": _arr(
            rng.integers(1, 50, nwr).astype(np.int64)),
        "wr_return_amt": _money(rng, nwr, 1, 500),
        "wr_refunded_cash": _money(rng, nwr, 0, 400),
        "wr_fee": _money(rng, nwr, 1, 100),
        "wr_net_loss": _money(rng, nwr, 1, 300),
    })

    # ---- inventory (weekly snapshots) ---------------------------------
    weeks = np.arange(0, _N_DAYS, 7)
    inv_items = np.arange(1, n_items + 1)
    grid_d, grid_i = np.meshgrid(weeks, inv_items, indexing="ij")
    ninv = grid_d.size
    tables["inventory"] = _table({
        "inv_date_sk": _arr(_DATE_SK0 + grid_d.ravel()),
        "inv_item_sk": _arr(grid_i.ravel().astype(np.int64)),
        "inv_warehouse_sk": _arr(
            rng.integers(1, n_wh + 1, ninv).astype(np.int64)),
        "inv_quantity_on_hand": _arr(
            np.clip(rng.lognormal(5.0, 1.4, ninv), 0, 8000).astype(
                np.int64)),
    })

    return tables


def load_delta(root: str, scale: int = 50_000, seed: int = 7, engine=None,
               tables: dict = None):
    """Write every table (`tables`, else `generate(scale, seed)`) as a
    Delta table under `root` through `api.write_table` and return a
    `Catalog` with every name registered."""
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.catalog import Catalog

    if tables is None:
        tables = generate(scale, seed)
    cat = Catalog(root, engine=engine)
    for name, batch in tables.items():
        path = os.path.join(root, name)
        write_table(path, batch, engine=cat.engine)
        if not cat.exists(name):
            cat.register(name, path)
    return cat


# the corpus' single-block texts, as `benchmarks/tpcds_queries.py` holds
# them
QUERIES = {
    "q3": r"""
select  dt.d_year
       ,item.i_brand_id brand_id
       ,item.i_brand brand
       ,sum(ss_sales_price) sum_agg
 from  date_dim dt
      ,store_sales
      ,item
 where dt.d_date_sk = store_sales.ss_sold_date_sk
   and store_sales.ss_item_sk = item.i_item_sk
   and item.i_manufact_id = 816
   and dt.d_moy=11
 group by dt.d_year
      ,item.i_brand
      ,item.i_brand_id
 order by dt.d_year
         ,sum_agg desc
         ,brand_id
 limit 100
""",
    "q7": r"""
select  i_item_id,
        avg(ss_quantity) agg1,
        avg(ss_list_price) agg2,
        avg(ss_coupon_amt) agg3,
        avg(ss_sales_price) agg4
 from store_sales, customer_demographics, date_dim, item, promotion
 where ss_sold_date_sk = d_date_sk and
       ss_item_sk = i_item_sk and
       ss_cdemo_sk = cd_demo_sk and
       ss_promo_sk = p_promo_sk and
       cd_gender = 'F' and
       cd_marital_status = 'W' and
       cd_education_status = 'College' and
       (p_channel_email = 'N' or p_channel_event = 'N') and
       d_year = 2001
 group by i_item_id
 order by i_item_id
 limit 100
""",
    "q13": r"""
select avg(ss_quantity)
       ,avg(ss_ext_sales_price)
       ,avg(ss_ext_wholesale_cost)
       ,sum(ss_ext_wholesale_cost)
 from store_sales
     ,store
     ,customer_demographics
     ,household_demographics
     ,customer_address
     ,date_dim
 where s_store_sk = ss_store_sk
 and  ss_sold_date_sk = d_date_sk and d_year = 2001
 and((ss_hdemo_sk=hd_demo_sk
  and cd_demo_sk = ss_cdemo_sk
  and cd_marital_status = 'U'
  and cd_education_status = 'Unknown'
  and ss_sales_price between 100.00 and 150.00
  and hd_dep_count = 3
     )or
     (ss_hdemo_sk=hd_demo_sk
  and cd_demo_sk = ss_cdemo_sk
  and cd_marital_status = 'W'
  and cd_education_status = '2 yr Degree'
  and ss_sales_price between 50.00 and 100.00
  and hd_dep_count = 1
     ) or
     (ss_hdemo_sk=hd_demo_sk
  and cd_demo_sk = ss_cdemo_sk
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and ss_sales_price between 150.00 and 200.00
  and hd_dep_count = 1
     ))
 and((ss_addr_sk = ca_address_sk
  and ca_country = 'United States'
  and ca_state in ('WV', 'GA', 'TX')
  and ss_net_profit between 100 and 200
     ) or
     (ss_addr_sk = ca_address_sk
  and ca_country = 'United States'
  and ca_state in ('TN', 'KY', 'SC')
  and ss_net_profit between 150 and 300
     ) or
     (ss_addr_sk = ca_address_sk
  and ca_country = 'United States'
  and ca_state in ('OK', 'NE', 'CA')
  and ss_net_profit between 50 and 250
     ))
""",
    "q15": r"""
select  ca_zip
       ,sum(cs_sales_price)
 from catalog_sales
     ,customer
     ,customer_address
     ,date_dim
 where cs_bill_customer_sk = c_customer_sk
 	and c_current_addr_sk = ca_address_sk
 	and ( substr(ca_zip,1,5) in ('85669', '86197','88274','83405','86475',
                                   '85392', '85460', '80348', '81792')
 	      or ca_state in ('CA','WA','GA')
 	      or cs_sales_price > 500)
 	and cs_sold_date_sk = d_date_sk
 	and d_qoy = 1 and d_year = 2000
 group by ca_zip
 order by ca_zip
 limit 100
""",
    "q17": r"""
select  i_item_id
       ,i_item_desc
       ,s_state
       ,count(ss_quantity) as store_sales_quantitycount
       ,avg(ss_quantity) as store_sales_quantityave
       ,stddev_samp(ss_quantity) as store_sales_quantitystdev
       ,stddev_samp(ss_quantity)/avg(ss_quantity) as store_sales_quantitycov
       ,count(sr_return_quantity) as store_returns_quantitycount
       ,avg(sr_return_quantity) as store_returns_quantityave
       ,stddev_samp(sr_return_quantity) as store_returns_quantitystdev
       ,stddev_samp(sr_return_quantity)/avg(sr_return_quantity) as store_returns_quantitycov
       ,count(cs_quantity) as catalog_sales_quantitycount ,avg(cs_quantity) as catalog_sales_quantityave
       ,stddev_samp(cs_quantity) as catalog_sales_quantitystdev
       ,stddev_samp(cs_quantity)/avg(cs_quantity) as catalog_sales_quantitycov
 from store_sales
     ,store_returns
     ,catalog_sales
     ,date_dim d1
     ,date_dim d2
     ,date_dim d3
     ,store
     ,item
 where d1.d_quarter_name = '1999Q1'
   and d1.d_date_sk = ss_sold_date_sk
   and i_item_sk = ss_item_sk
   and s_store_sk = ss_store_sk
   and ss_customer_sk = sr_customer_sk
   and ss_item_sk = sr_item_sk
   and ss_ticket_number = sr_ticket_number
   and sr_returned_date_sk = d2.d_date_sk
   and d2.d_quarter_name in ('1999Q1','1999Q2','1999Q3')
   and sr_customer_sk = cs_bill_customer_sk
   and sr_item_sk = cs_item_sk
   and cs_sold_date_sk = d3.d_date_sk
   and d3.d_quarter_name in ('1999Q1','1999Q2','1999Q3')
 group by i_item_id
         ,i_item_desc
         ,s_state
 order by i_item_id
         ,i_item_desc
         ,s_state
limit 100
""",
    "q19": r"""
select  i_brand_id brand_id, i_brand brand, i_manufact_id, i_manufact,
 	sum(ss_ext_sales_price) ext_price
 from date_dim, store_sales, item,customer,customer_address,store
 where d_date_sk = ss_sold_date_sk
   and ss_item_sk = i_item_sk
   and i_manager_id=26
   and d_moy=12
   and d_year=2000
   and ss_customer_sk = c_customer_sk
   and c_current_addr_sk = ca_address_sk
   and substr(ca_zip,1,5) <> substr(s_zip,1,5)
   and ss_store_sk = s_store_sk
 group by i_brand
      ,i_brand_id
      ,i_manufact_id
      ,i_manufact
 order by ext_price desc
         ,i_brand
         ,i_brand_id
         ,i_manufact_id
         ,i_manufact
limit 100 
""",
    "q25": r"""
select
 i_item_id
 ,i_item_desc
 ,s_store_id
 ,s_store_name
 ,sum(ss_net_profit) as store_sales_profit
 ,sum(sr_net_loss) as store_returns_loss
 ,sum(cs_net_profit) as catalog_sales_profit
 from
 store_sales
 ,store_returns
 ,catalog_sales
 ,date_dim d1
 ,date_dim d2
 ,date_dim d3
 ,store
 ,item
 where
 d1.d_moy = 4
 and d1.d_year = 2002
 and d1.d_date_sk = ss_sold_date_sk
 and i_item_sk = ss_item_sk
 and s_store_sk = ss_store_sk
 and ss_customer_sk = sr_customer_sk
 and ss_item_sk = sr_item_sk
 and ss_ticket_number = sr_ticket_number
 and sr_returned_date_sk = d2.d_date_sk
 and d2.d_moy               between 4 and  10
 and d2.d_year              = 2002
 and sr_customer_sk = cs_bill_customer_sk
 and sr_item_sk = cs_item_sk
 and cs_sold_date_sk = d3.d_date_sk
 and d3.d_moy               between 4 and  10
 and d3.d_year              = 2002
 group by
 i_item_id
 ,i_item_desc
 ,s_store_id
 ,s_store_name
 order by
 i_item_id
 ,i_item_desc
 ,s_store_id
 ,s_store_name
 limit 100
""",
    "q26": r"""
select  i_item_id,
        avg(cs_quantity) agg1,
        avg(cs_list_price) agg2,
        avg(cs_coupon_amt) agg3,
        avg(cs_sales_price) agg4
 from catalog_sales, customer_demographics, date_dim, item, promotion
 where cs_sold_date_sk = d_date_sk and
       cs_item_sk = i_item_sk and
       cs_bill_cdemo_sk = cd_demo_sk and
       cs_promo_sk = p_promo_sk and
       cd_gender = 'F' and
       cd_marital_status = 'M' and
       cd_education_status = '2 yr Degree' and
       (p_channel_email = 'N' or p_channel_event = 'N') and
       d_year = 2002
 group by i_item_id
 order by i_item_id
 limit 100
""",
    "q29": r"""
select
     i_item_id
    ,i_item_desc
    ,s_store_id
    ,s_store_name
    ,stddev_samp(ss_quantity)        as store_sales_quantity
    ,stddev_samp(sr_return_quantity) as store_returns_quantity
    ,stddev_samp(cs_quantity)        as catalog_sales_quantity
 from
    store_sales
   ,store_returns
   ,catalog_sales
   ,date_dim             d1
   ,date_dim             d2
   ,date_dim             d3
   ,store
   ,item
 where
     d1.d_moy               = 4
 and d1.d_year              = 1998
 and d1.d_date_sk           = ss_sold_date_sk
 and i_item_sk              = ss_item_sk
 and s_store_sk             = ss_store_sk
 and ss_customer_sk         = sr_customer_sk
 and ss_item_sk             = sr_item_sk
 and ss_ticket_number       = sr_ticket_number
 and sr_returned_date_sk    = d2.d_date_sk
 and d2.d_moy               between 4 and  4 + 3
 and d2.d_year              = 1998
 and sr_customer_sk         = cs_bill_customer_sk
 and sr_item_sk             = cs_item_sk
 and cs_sold_date_sk        = d3.d_date_sk
 and d3.d_year              in (1998,1998+1,1998+2)
 group by
    i_item_id
   ,i_item_desc
   ,s_store_id
   ,s_store_name
 order by
    i_item_id
   ,i_item_desc
   ,s_store_id
   ,s_store_name
 limit 100
""",
    "q37": r"""
select  i_item_id
       ,i_item_desc
       ,i_current_price
 from item, inventory, date_dim, catalog_sales
 where i_current_price between 35 and 35 + 30
 and inv_item_sk = i_item_sk
 and d_date_sk=inv_date_sk
 and d_date between cast('2001-01-20' as date) and (cast('2001-01-20' as date) + interval 60 days)
 and i_manufact_id in (928,715,942,861)
 and inv_quantity_on_hand between 100 and 500
 and cs_item_sk = i_item_sk
 group by i_item_id,i_item_desc,i_current_price
 order by i_item_id
 limit 100
""",
    "q42": r"""
select  dt.d_year
 	,item.i_category_id
 	,item.i_category
 	,sum(ss_ext_sales_price)
 from 	date_dim dt
 	,store_sales
 	,item
 where dt.d_date_sk = store_sales.ss_sold_date_sk
 	and store_sales.ss_item_sk = item.i_item_sk
 	and item.i_manager_id = 1
 	and dt.d_moy=11
 	and dt.d_year=2002
 group by 	dt.d_year
 		,item.i_category_id
 		,item.i_category
 order by       sum(ss_ext_sales_price) desc,dt.d_year
 		,item.i_category_id
 		,item.i_category
limit 100 
""",
    "q43": r"""
select  s_store_name, s_store_id,
        sum(case when (d_day_name='Sunday') then ss_sales_price else null end) sun_sales,
        sum(case when (d_day_name='Monday') then ss_sales_price else null end) mon_sales,
        sum(case when (d_day_name='Tuesday') then ss_sales_price else  null end) tue_sales,
        sum(case when (d_day_name='Wednesday') then ss_sales_price else null end) wed_sales,
        sum(case when (d_day_name='Thursday') then ss_sales_price else null end) thu_sales,
        sum(case when (d_day_name='Friday') then ss_sales_price else null end) fri_sales,
        sum(case when (d_day_name='Saturday') then ss_sales_price else null end) sat_sales
 from date_dim, store_sales, store
 where d_date_sk = ss_sold_date_sk and
       s_store_sk = ss_store_sk and
       s_gmt_offset = -6 and
       d_year = 1999
 group by s_store_name, s_store_id
 order by s_store_name, s_store_id,sun_sales,mon_sales,tue_sales,wed_sales,thu_sales,fri_sales,sat_sales
 limit 100
""",
    "q48": r"""
select sum (ss_quantity)
 from store_sales, store, customer_demographics, customer_address, date_dim
 where s_store_sk = ss_store_sk
 and  ss_sold_date_sk = d_date_sk and d_year = 1999
 and
 (
  (
   cd_demo_sk = ss_cdemo_sk
   and
   cd_marital_status = 'D'
   and
   cd_education_status = 'College'
   and
   ss_sales_price between 100.00 and 150.00
   )
 or
  (
  cd_demo_sk = ss_cdemo_sk
   and
   cd_marital_status = 'W'
   and
   cd_education_status = 'Secondary'
   and
   ss_sales_price between 50.00 and 100.00
  )
 or
 (
  cd_demo_sk = ss_cdemo_sk
  and
   cd_marital_status = 'M'
   and
   cd_education_status = '2 yr Degree'
   and
   ss_sales_price between 150.00 and 200.00
 )
 )
 and
 (
  (
  ss_addr_sk = ca_address_sk
  and
  ca_country = 'United States'
  and
  ca_state in ('NE', 'IA', 'NY')
  and ss_net_profit between 0 and 2000
  )
 or
  (ss_addr_sk = ca_address_sk
  and
  ca_country = 'United States'
  and
  ca_state in ('IN', 'TN', 'OH')
  and ss_net_profit between 150 and 3000
  )
 or
  (ss_addr_sk = ca_address_sk
  and
  ca_country = 'United States'
  and
  ca_state in ('KS', 'CA', 'CO')
  and ss_net_profit between 50 and 25000
  )
 )
""",
    "q50": r"""
select
   s_store_name
  ,s_company_id
  ,s_street_number
  ,s_street_name
  ,s_street_type
  ,s_suite_number
  ,s_city
  ,s_county
  ,s_state
  ,s_zip
  ,sum(case when (sr_returned_date_sk - ss_sold_date_sk <= 30 ) then 1 else 0 end)  as `30 days`
  ,sum(case when (sr_returned_date_sk - ss_sold_date_sk > 30) and
                 (sr_returned_date_sk - ss_sold_date_sk <= 60) then 1 else 0 end )  as `31-60 days`
  ,sum(case when (sr_returned_date_sk - ss_sold_date_sk > 60) and
                 (sr_returned_date_sk - ss_sold_date_sk <= 90) then 1 else 0 end)  as `61-90 days`
  ,sum(case when (sr_returned_date_sk - ss_sold_date_sk > 90) and
                 (sr_returned_date_sk - ss_sold_date_sk <= 120) then 1 else 0 end)  as `91-120 days`
  ,sum(case when (sr_returned_date_sk - ss_sold_date_sk  > 120) then 1 else 0 end)  as `>120 days`
from
   store_sales
  ,store_returns
  ,store
  ,date_dim d1
  ,date_dim d2
where
    d2.d_year = 1999
and d2.d_moy  = 9
and ss_ticket_number = sr_ticket_number
and ss_item_sk = sr_item_sk
and ss_sold_date_sk   = d1.d_date_sk
and sr_returned_date_sk   = d2.d_date_sk
and ss_customer_sk = sr_customer_sk
and ss_store_sk = s_store_sk
group by
   s_store_name
  ,s_company_id
  ,s_street_number
  ,s_street_name
  ,s_street_type
  ,s_suite_number
  ,s_city
  ,s_county
  ,s_state
  ,s_zip
order by s_store_name
        ,s_company_id
        ,s_street_number
        ,s_street_name
        ,s_street_type
        ,s_suite_number
        ,s_city
        ,s_county
        ,s_state
        ,s_zip
limit 100
""",
    "q52": r"""
select  dt.d_year
 	,item.i_brand_id brand_id
 	,item.i_brand brand
 	,sum(ss_ext_sales_price) ext_price
 from date_dim dt
     ,store_sales
     ,item
 where dt.d_date_sk = store_sales.ss_sold_date_sk
    and store_sales.ss_item_sk = item.i_item_sk
    and item.i_manager_id = 1
    and dt.d_moy=11
    and dt.d_year=2001
 group by dt.d_year
 	,item.i_brand
 	,item.i_brand_id
 order by dt.d_year
 	,ext_price desc
 	,brand_id
limit 100 
""",
    "q55": r"""
select  i_brand_id brand_id, i_brand brand,
 	sum(ss_ext_sales_price) ext_price
 from date_dim, store_sales, item
 where d_date_sk = ss_sold_date_sk
 	and ss_item_sk = i_item_sk
 	and i_manager_id=87
 	and d_moy=11
 	and d_year=2001
 group by i_brand, i_brand_id
 order by ext_price desc, i_brand_id
limit 100 
""",
    "q62": r"""
select
   substr(w_warehouse_name,1,20)
  ,sm_type
  ,web_name
  ,sum(case when (ws_ship_date_sk - ws_sold_date_sk <= 30 ) then 1 else 0 end)  as `30 days`
  ,sum(case when (ws_ship_date_sk - ws_sold_date_sk > 30) and
                 (ws_ship_date_sk - ws_sold_date_sk <= 60) then 1 else 0 end )  as `31-60 days`
  ,sum(case when (ws_ship_date_sk - ws_sold_date_sk > 60) and
                 (ws_ship_date_sk - ws_sold_date_sk <= 90) then 1 else 0 end)  as `61-90 days`
  ,sum(case when (ws_ship_date_sk - ws_sold_date_sk > 90) and
                 (ws_ship_date_sk - ws_sold_date_sk <= 120) then 1 else 0 end)  as `91-120 days`
  ,sum(case when (ws_ship_date_sk - ws_sold_date_sk  > 120) then 1 else 0 end)  as `>120 days`
from
   web_sales
  ,warehouse
  ,ship_mode
  ,web_site
  ,date_dim
where
    d_month_seq between 1194 and 1194 + 11
and ws_ship_date_sk   = d_date_sk
and ws_warehouse_sk   = w_warehouse_sk
and ws_ship_mode_sk   = sm_ship_mode_sk
and ws_web_site_sk    = web_site_sk
group by
   substr(w_warehouse_name,1,20)
  ,sm_type
  ,web_name
order by substr(w_warehouse_name,1,20)
        ,sm_type
       ,web_name
limit 100
""",
    "q82": r"""
select  i_item_id
       ,i_item_desc
       ,i_current_price
 from item, inventory, date_dim, store_sales
 where i_current_price between 82 and 82+30
 and inv_item_sk = i_item_sk
 and d_date_sk=inv_date_sk
 and d_date between cast('2002-03-10' as date) and (cast('2002-03-10' as date) +  INTERVAL 60 days)
 and i_manufact_id in (941,920,105,693)
 and inv_quantity_on_hand between 100 and 500
 and ss_item_sk = i_item_sk
 group by i_item_id,i_item_desc,i_current_price
 order by i_item_id
 limit 100
""",
    "q84": r"""
select  c_customer_id as customer_id
       , coalesce(c_last_name,'') || ', ' || coalesce(c_first_name,'') as customername
 from customer
     ,customer_address
     ,customer_demographics
     ,household_demographics
     ,income_band
     ,store_returns
 where ca_city	        =  'Antioch'
   and c_current_addr_sk = ca_address_sk
   and ib_lower_bound   >=  55019
   and ib_upper_bound   <=  55019 + 50000
   and ib_income_band_sk = hd_income_band_sk
   and cd_demo_sk = c_current_cdemo_sk
   and hd_demo_sk = c_current_hdemo_sk
   and sr_cdemo_sk = cd_demo_sk
 order by c_customer_id
 limit 100
""",
    "q85": r"""
select  substr(r_reason_desc,1,20)
       ,avg(ws_quantity)
       ,avg(wr_refunded_cash)
       ,avg(wr_fee)
 from web_sales, web_returns, web_page, customer_demographics cd1,
      customer_demographics cd2, customer_address, date_dim, reason
 where ws_web_page_sk = wp_web_page_sk
   and ws_item_sk = wr_item_sk
   and ws_order_number = wr_order_number
   and ws_sold_date_sk = d_date_sk and d_year = 2001
   and cd1.cd_demo_sk = wr_refunded_cdemo_sk
   and cd2.cd_demo_sk = wr_returning_cdemo_sk
   and ca_address_sk = wr_refunded_addr_sk
   and r_reason_sk = wr_reason_sk
   and
   (
    (
     cd1.cd_marital_status = 'S'
     and
     cd1.cd_marital_status = cd2.cd_marital_status
     and
     cd1.cd_education_status = '2 yr Degree'
     and
     cd1.cd_education_status = cd2.cd_education_status
     and
     ws_sales_price between 100.00 and 150.00
    )
   or
    (
     cd1.cd_marital_status = 'D'
     and
     cd1.cd_marital_status = cd2.cd_marital_status
     and
     cd1.cd_education_status = 'Advanced Degree'
     and
     cd1.cd_education_status = cd2.cd_education_status
     and
     ws_sales_price between 50.00 and 100.00
    )
   or
    (
     cd1.cd_marital_status = 'W'
     and
     cd1.cd_marital_status = cd2.cd_marital_status
     and
     cd1.cd_education_status = '4 yr Degree'
     and
     cd1.cd_education_status = cd2.cd_education_status
     and
     ws_sales_price between 150.00 and 200.00
    )
   )
   and
   (
    (
     ca_country = 'United States'
     and
     ca_state in ('OK', 'TX', 'MO')
     and ws_net_profit between 100 and 200
    )
    or
    (
     ca_country = 'United States'
     and
     ca_state in ('GA', 'KS', 'NC')
     and ws_net_profit between 150 and 300
    )
    or
    (
     ca_country = 'United States'
     and
     ca_state in ('VA', 'WI', 'WV')
     and ws_net_profit between 50 and 250
    )
   )
group by r_reason_desc
order by substr(r_reason_desc,1,20)
        ,avg(ws_quantity)
        ,avg(wr_refunded_cash)
        ,avg(wr_fee)
limit 100
""",
    "q91": r"""
select
        cc_call_center_id Call_Center,
        cc_name Call_Center_Name,
        cc_manager Manager,
        sum(cr_net_loss) Returns_Loss
from
        call_center,
        catalog_returns,
        date_dim,
        customer,
        customer_address,
        customer_demographics,
        household_demographics
where
        cr_call_center_sk       = cc_call_center_sk
and     cr_returned_date_sk     = d_date_sk
and     cr_returning_customer_sk= c_customer_sk
and     cd_demo_sk              = c_current_cdemo_sk
and     hd_demo_sk              = c_current_hdemo_sk
and     ca_address_sk           = c_current_addr_sk
and     d_year                  = 2002
and     d_moy                   = 11
and     ( (cd_marital_status       = 'M' and cd_education_status     = 'Unknown')
        or(cd_marital_status       = 'W' and cd_education_status     = 'Advanced Degree'))
and     hd_buy_potential like '5001-10000%'
and     ca_gmt_offset           = -6
group by cc_call_center_id,cc_name,cc_manager,cd_marital_status,cd_education_status
order by sum(cr_net_loss) desc
""",
    "q96": r"""
select  count(*)
from store_sales
    ,household_demographics
    ,time_dim, store
where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 16
    and time_dim.t_minute >= 30
    and household_demographics.hd_dep_count = 4
    and store.s_store_name = 'ese'
order by count(*)
limit 100
""",
    "q99": r"""
select
   substr(w_warehouse_name,1,20)
  ,sm_type
  ,cc_name
  ,sum(case when (cs_ship_date_sk - cs_sold_date_sk <= 30 ) then 1 else 0 end)  as `30 days`
  ,sum(case when (cs_ship_date_sk - cs_sold_date_sk > 30) and
                 (cs_ship_date_sk - cs_sold_date_sk <= 60) then 1 else 0 end )  as `31-60 days`
  ,sum(case when (cs_ship_date_sk - cs_sold_date_sk > 60) and
                 (cs_ship_date_sk - cs_sold_date_sk <= 90) then 1 else 0 end)  as `61-90 days`
  ,sum(case when (cs_ship_date_sk - cs_sold_date_sk > 90) and
                 (cs_ship_date_sk - cs_sold_date_sk <= 120) then 1 else 0 end)  as `91-120 days`
  ,sum(case when (cs_ship_date_sk - cs_sold_date_sk  > 120) then 1 else 0 end)  as `>120 days`
from
   catalog_sales
  ,warehouse
  ,ship_mode
  ,call_center
  ,date_dim
where
    d_month_seq between 1203 and 1203 + 11
and cs_ship_date_sk   = d_date_sk
and cs_warehouse_sk   = w_warehouse_sk
and cs_ship_mode_sk   = sm_ship_mode_sk
and cs_call_center_sk = cc_call_center_sk
group by
   substr(w_warehouse_name,1,20)
  ,sm_type
  ,cc_name
order by substr(w_warehouse_name,1,20)
        ,sm_type
        ,cc_name
limit 100
""",
}
