"""The port's Flickr scraper (witw_tpu_torch.tools.flickr: config, search,
uploader) against witw_tpu's through the same fakes as tests/test_tools.py:
the reference config.yaml shape read without PyYAML, the bbox partition,
a scrape, resume after a kill, replay and the local downloader. Also the
YAML reader's ``nested`` shapes against PyYAML."""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses
import json
import os

import pytest
import yaml

from witw_tpu.tools.flickr import config as jcfg
from witw_tpu.tools.flickr import search as jsearch
from witw_tpu.tools.flickr import uploader as jup
from witw_tpu_torch.configs import serialize
from witw_tpu_torch.tools.flickr import config as tcfg
from witw_tpu_torch.tools.flickr import search as tsearch
from witw_tpu_torch.tools.flickr import uploader as tup

PACKAGES = {"witw_tpu": (jcfg, jsearch, jup), "port": (tcfg, tsearch, tup)}

REFERENCE_YAML = (
    "# the reference scraper's config.yaml\n"
    "url_field: \"url_m\"\n"
    "page_size: 100\n"
    "density_limit: 4000\n"
    "min_area: 1\n"
    "max_area: 2000000\n"
    "time_delay: 2\n"
    "refresh_metadata: False\n"
    "cities:\n"
    "  - name: \"03_paris\"\n"
    "    bounding_boxes: [[2.1109464,48.4492509,2.3131089,49.0767795]]\n"
    "    download: \"both\"\n"
    "    download_limit: -1\n"
    "  - name: \"09_san\"\n"
    "    bounding_boxes: [[-66.0202785,18.3164733,-65.8945476,18.510336], [1, 2, 3, 4]]\n"
    "    download: 'both'  # a comment\n"
    "    download_limit: -1\n"
    "  - name: rio\n"
    "    bounding_boxes: []\n"
)


@pytest.mark.parametrize("text", [
    REFERENCE_YAML,
    "api_key: k\nper_page: 50\ncities:\n  paris: [2.2, 48.8, 2.4, 48.9]\n  vegas:\n  - -115.3\n"
    "  - 36.1\n  - -115.1\n  - 36.3\nlicenses: ['4', '5']\nout_dir: ./o\ngeo_context: 2\n",
    "",
], ids=["reference", "flat", "empty"])
def test_scraper_config_from_yaml_matches(tmp_path, text):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    want = dataclasses.asdict(jcfg.ScraperConfig.from_yaml(str(path)))
    got = dataclasses.asdict(tcfg.ScraperConfig.from_yaml(str(path)))
    assert got == want


def test_scraper_config_warns_on_unknown_keys(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("mystery: 1\nrefresh_metadata: true\n")
    with pytest.warns(UserWarning, match="mystery"):
        tcfg.ScraperConfig.from_yaml(str(path))
    assert tcfg.DEFAULT_CITY_BBOXES == jcfg.DEFAULT_CITY_BBOXES
    assert tcfg.ALLOWED_LICENSES == jcfg.ALLOWED_LICENSES


NESTED = [
    REFERENCE_YAML,
    "x:\n- a: 1\n  b: [1, 'x, y', [], [2,  [3]], \"q\"]\n-   c: 2\n    d:\n      e: 3\n- 5\n",
    "a: [ ]\nb: [-1.5e+3, .inf, null, true, ~]\nc:\n  - k: v\n    l:\n    - 1\n    - 2\n",
]


@pytest.mark.parametrize("text", NESTED, ids=["reference", "items", "flow-scalars"])
def test_nested_yaml_reads_as_pyyaml(text):
    assert serialize.load_scraper_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: [1, 2\n", "a: [1, {b: 2}]\n", "a: [1, 2] x\n", "a: [1,,2]\n",
                                  "a:\n- - 1\n", "a:\n- b: 1\n   c: 2\n", "a: [1, &x 2]\n"])
def test_nested_yaml_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        serialize.load_scraper_yaml(text)


@pytest.mark.parametrize("text", ["a: [1, 2]\n", "a:\n- b: 1\n"])
def test_config_yaml_still_refuses_nested_shapes(text):
    """An experiment config keeps the subset that yaml.safe_dump writes."""
    with pytest.raises(ValueError):
        serialize.load_yaml(text)


def make_stub_api(photos):
    """tests/test_tools.py's stub: filters the photos by the requested bbox
    and pages them."""
    def api(params, key, retries=3):
        bbox = tuple(float(v) for v in params["bbox"].split(","))
        hits = [p for p in photos
                if bbox[0] <= p["longitude"] <= bbox[2] and bbox[1] <= p["latitude"] <= bbox[3]]
        per_page = int(params.get("per_page", 250))
        page = int(params.get("page", 1))
        start = (page - 1) * per_page
        return {"stat": "ok", "photos": {"total": len(hits),
                                         "pages": max(1, -(-len(hits) // per_page)),
                                         "photo": hits[start:start + per_page]}}
    return api


def _photos(rng, n=60):
    photos = [{"id": str(i), "latitude": float(rng.uniform(48.8, 48.9)),
               "longitude": float(rng.uniform(2.2, 2.4)),
               **({"url_o": f"http://x/{i}_o.jpg"} if i % 3 else {"url_m": f"http://x/{i}_m.jpg"})}
              for i in range(n)]
    photos.append(dict(photos[0]))  # one id twice: dedup
    return photos


def _scrape(pkg, out_dir, api, **kw):
    cfg_mod, search, _ = PACKAGES[pkg]
    cfg = cfg_mod.ScraperConfig(out_dir=str(out_dir), max_per_box=20, time_delay=0.0, per_page=7,
                                cities={"paris": (2.2, 48.8, 2.4, 48.9)})
    return search.scrape_city("paris", cfg, api, **kw)


def test_partition_and_scrape_match(tmp_path, rng):
    api = make_stub_api(_photos(rng))
    cfgs = {p: PACKAGES[p][0].ScraperConfig(max_per_box=20, time_delay=0.0) for p in PACKAGES}
    boxes = {p: PACKAGES[p][1].partition_bboxes((2.2, 48.8, 2.4, 48.9), cfgs[p], api) for p in PACKAGES}
    assert boxes["port"] == boxes["witw_tpu"] and len(boxes["port"]) >= 3
    records = {p: _scrape(p, tmp_path / p, api) for p in PACKAGES}
    assert records["port"] == records["witw_tpu"] and len(records["port"]) == 60
    for name in ("metadata.json", "urls"):
        assert (tmp_path / "port" / "paris" / name).read_bytes() == \
            (tmp_path / "witw_tpu" / "paris" / name).read_bytes()


def test_scrape_resume_after_kill_matches(tmp_path, rng):
    """Killed in its second box's pages, re-run: both packages resume from
    the same snapshot and converge to the uninterrupted set; on_photo fires
    for the new photos only."""
    full = make_stub_api(_photos(rng))
    seen = {}
    for pkg in PACKAGES:
        calls = {"n": 0}

        def dying(params, key, retries=3):
            if "extras" in params:
                calls["n"] += 1
                if calls["n"] > 3:
                    raise RuntimeError("killed mid-city")
            return full(params, key, retries)

        with pytest.raises(RuntimeError):
            _scrape(pkg, tmp_path / pkg, dying)
        partial = PACKAGES[pkg][1].read_metadata(str(tmp_path / pkg / "paris"))
        new = []
        records = _scrape(pkg, tmp_path / pkg, full, on_photo=lambda p: new.append(p["id"]))
        again = []
        _scrape(pkg, tmp_path / pkg, full, on_photo=lambda p: again.append(p["id"]))
        seen[pkg] = (partial, new, records, again,
                     PACKAGES[pkg][1].get_known_urls(str(tmp_path / pkg / "paris")))
    assert seen["port"] == seen["witw_tpu"]
    partial, new, records, again, urls = seen["port"]
    assert 0 < len(partial) < 60 and len(new) == 60 - len(partial) and not again
    assert len(records) == len(urls) == 60


def test_download_and_replay_match(tmp_path):
    def fetch(url):
        if "bad" in url:
            raise IOError("404")
        return b"data-" + url.encode()

    root = tmp_path / "meta"
    for city, recs in (("paris", [{"id": "1", "url_o": "http://x/a.jpg"},
                                  {"id": "2", "url_m": "http://x/bad.jpg"}]),
                       ("vegas", [{"id": "3", "url": "http://x/c.jpg"}, {"id": "4"}])):
        (root / city).mkdir(parents=True)
        (root / city / "metadata.json").write_text(json.dumps(recs))
    (root / "empty").mkdir()
    results = {}
    for pkg, (_, _, up) in PACKAGES.items():
        ok, failed = up.download_local([("http://x/a.jpg", "paris"), ("http://x/bad.jpg", "paris")],
                                       str(tmp_path / pkg / "dl"), n_workers=2, fetch=fetch)
        counts = up.replay_metadata(str(root), out_dir=str(tmp_path / pkg / "dl2"),
                                    failures_path=str(tmp_path / pkg / "failed.txt"), fetch=fetch)
        files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / pkg)
                       for d, _, fs in os.walk(tmp_path / pkg) for f in fs)
        results[pkg] = (ok, failed, counts, files, (tmp_path / pkg / "failed.txt").read_text())
    assert results["port"] == results["witw_tpu"]
    assert results["port"][2] == (2, 1)


def test_area_guards_and_url_helpers_match():
    box = (2.2, 48.8, 2.4, 48.9)
    assert tsearch.est_area_m2(box) == jsearch.est_area_m2(box)
    for b in (box, (0, 0, 2, 10)):
        assert tsearch.split_bbox(b) == jsearch.split_bbox(b)
    calls = {p: [] for p in PACKAGES}
    for pkg, (cfg_mod, search, _) in PACKAGES.items():
        def api(params, key, retries=3, log=calls[pkg]):
            log.append(params["bbox"])
            return {"stat": "ok", "photos": {"total": 10_000, "pages": 1, "photo": []}}
        cfg = cfg_mod.ScraperConfig(max_per_box=100, time_delay=0.0, max_area_m2=1.0e8,
                                    min_area_m2=9.0e7)
        assert len(search.partition_bboxes(box, cfg, api)) == 2
    assert calls["port"] == calls["witw_tpu"] and len(calls["port"]) == 2
    for rec in ({"url_o": "O", "url_m": "M"}, {"url_m": "M"}, {"url": "legacy"}, {}):
        for prefer in ("url_o", "url_m"):
            assert tsearch.photo_url(rec, prefer) == jsearch.photo_url(rec, prefer)
    assert tsearch.EXTRAS == jsearch.EXTRAS and tsearch.API_URL == jsearch.API_URL


def test_api_key_chain_matches(tmp_path, monkeypatch):
    secret_root = tmp_path / "run_secrets"
    secret_root.mkdir()
    (secret_root / "flickr_api_key").write_text("docker-secret-key\nmore\n")
    key_file = tmp_path / "keyfile"
    key_file.write_text("file-key\n")
    cases = [({}, ""), ({"FLICKR_API_KEY_FILE": str(key_file)}, ""),
             ({"FLICKR_API_KEY": "env-key", "FLICKR_API_KEY_FILE": str(key_file)}, ""),
             ({"FLICKR_API_KEY": "env-key"}, "cli-key"),
             ({"FLICKR_API_KEY_FILE": str(tmp_path / "typo")}, "")]
    for env, cli in cases:
        monkeypatch.delenv("FLICKR_API_KEY", raising=False)
        monkeypatch.delenv("FLICKR_API_KEY_FILE", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tsearch.resolve_api_key(cli, secret_root=str(secret_root)) == \
            jsearch.resolve_api_key(cli, secret_root=str(secret_root))
    assert tsearch.read_secret_file(str(tmp_path / "missing")) == ""
