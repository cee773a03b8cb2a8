"""Photo download fan-out: local pool or AWS Lambda -> S3 (port of
witw_tpu/tools/flickr/uploader.py; host code, no device work).

Covers three reference components:
- the Lambda handler that streams one URL into S3
  (reference tools/lambda_uploader/handler.py:7-43),
- the scraper's Lambda fan-out (reference flickr_search.py:278-342),
- the metadata re-driver that replays saved metadata.json through the Lambda
  logging failures (reference tools/metadata_reader/reader.py:41-95).

boto3 is not installed in this environment; AWS paths are import-gated and a
local thread-pool downloader provides the same capability without AWS.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple


def lambda_handler(event: Dict, context=None) -> Dict:  # pragma: no cover - AWS path
    """AWS Lambda entry point: stream event['url'] into S3 (reference
    tools/lambda_uploader/handler.py:7-43)."""
    import boto3
    import httpx

    url = event["url"]
    city = event.get("city", "unknown")
    bucket = os.environ["BUCKET"]
    filename = url.rsplit("/", 1)[-1]
    s3 = boto3.client("s3")
    with httpx.stream("GET", url, timeout=60.0) as resp:
        resp.raise_for_status()
        body = b"".join(resp.iter_bytes())
    s3.put_object(Bucket=bucket, Key=f"{city}/{filename}", Body=body)
    return {"statusCode": 200, "key": f"{city}/{filename}"}


def invoke_lambda_async(lambda_name: str, url: str, city: str) -> None:  # pragma: no cover
    """Fire-and-forget Lambda invocation (reference reader.py:60-78)."""
    import boto3

    client = boto3.client("lambda")
    client.invoke(
        FunctionName=lambda_name,
        InvocationType="Event",
        Payload=json.dumps({"url": url, "city": city}).encode(),
    )


def download_local(
    urls: Iterable[Tuple[str, str]],
    out_dir: str,
    n_workers: int = 16,
    fetch=None,
) -> Tuple[List[str], List[str]]:
    """Local downloader: (url, city) pairs -> out_dir/{city}/{filename}.
    Returns (succeeded, failed). ``fetch(url) -> bytes`` is injectable for
    tests; default uses httpx."""
    if fetch is None:  # pragma: no cover - network path
        import httpx

        def fetch(url: str) -> bytes:
            resp = httpx.get(url, timeout=60.0, follow_redirects=True)
            resp.raise_for_status()
            return resp.content

    succeeded: List[str] = []
    failed: List[str] = []

    def one(pair: Tuple[str, str]):
        url, city = pair
        try:
            data = fetch(url)
            city_dir = os.path.join(out_dir, city)
            os.makedirs(city_dir, exist_ok=True)
            with open(os.path.join(city_dir, url.rsplit("/", 1)[-1]), "wb") as f:
                f.write(data)
            succeeded.append(url)
        except Exception:
            failed.append(url)

    with ThreadPoolExecutor(n_workers) as pool:
        list(pool.map(one, list(urls)))
    return succeeded, failed


def replay_metadata(
    metadata_root: str,
    out_dir: Optional[str] = None,
    lambda_name: Optional[str] = None,
    failures_path: str = "failed_urls.txt",
    fetch=None,
) -> Tuple[int, int]:
    """Re-drive downloads from saved metadata.json files (reference
    tools/metadata_reader/reader.py:41-95): Lambda fan-out when
    ``lambda_name`` is set, local pool otherwise. Failures are logged."""
    jobs: List[Tuple[str, str]] = []
    for city in sorted(os.listdir(metadata_root)):
        path = os.path.join(metadata_root, city, "metadata.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for rec in json.load(f):
                from witw_tpu_torch.tools.flickr.search import photo_url

                url = photo_url(rec)  # url_o -> url_m -> legacy 'url'
                if url:
                    jobs.append((url, city))
    if lambda_name:  # pragma: no cover - AWS path
        failed = []
        for url, city in jobs:
            try:
                invoke_lambda_async(lambda_name, url, city)
            except Exception:
                failed.append(url)
        succeeded = [u for u, _ in jobs if u not in set(failed)]
    else:
        succeeded, failed = download_local(jobs, out_dir or "./photos", fetch=fetch)
    if failed:
        with open(failures_path, "w") as f:
            f.write("\n".join(failed) + "\n")
    return len(succeeded), len(failed)
