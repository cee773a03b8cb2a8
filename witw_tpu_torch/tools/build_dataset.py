"""End-to-end WITW dataset construction pipeline (port of
witw_tpu/tools/build_dataset.py, on the port's tables).

Python orchestrator replacing the reference bash pipeline
(reference tools/dataset_building/build_dataset:1-74). Stages:

1. metadata.json files -> annotated dataset.csv (tiles.build_csv)
2. drop single-band (grayscale) photos           (build_dataset:24-29)
3. drop indoor photos via a pluggable classifier (build_dataset:31-37 uses an
   external Places365 CNN; here any callable(path) -> bool is accepted, e.g.
   ``torch_indoor_classifier`` on the card, and the stage is skipped when
   none is given)
4. drop preset photo IDs                          (build_dataset:39-46)
5. clip 225 m overhead tiles per photo            (build_dataset:48-51)
6. drop tiles with > 5% blank pixels, counted on the card (build_dataset:53-57)
7. train/test split: Paris held out as test city  (build_dataset:59-63)
8. write train.csv / test.csv into the dataset layout (build_dataset:65-74)
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from witw_tpu_torch.data.csv_registry import Table, iter_rows, table_len, take_rows, write_table
from witw_tpu_torch.models.convert_torch import load_full_module
from witw_tpu_torch.tools import tiles
from witw_tpu_torch.tools.convert_8bit import zero_fraction
from witw_tpu_torch.tools.filter_csv import filter_frame, load_id_set
from witw_tpu_torch.tools.geotiff import GeoTiff
from witw_tpu_torch.utils.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def is_single_band(photo_path: str) -> bool:
    """Grayscale check (the reference shells out to `file` and greps
    'components 1', build_dataset:24-29): the image header's band count,
    read by PIL as witw_tpu reads it; an unreadable file counts as single
    band (it is dropped)."""
    try:
        from PIL import Image

        with Image.open(photo_path) as im:
            return len(im.getbands()) == 1
    except Exception:
        return True


def torch_indoor_classifier(
    checkpoint_path: str,
    io_map_path: str,
    device=None,
    input_size: int = 224,
) -> Callable[[str], bool]:
    """Indoor/outdoor classifier from a user-supplied torch scene-classifier
    checkpoint (a full pickled ``nn.Module``, see :func:`load_full_module`)
    run on ``device`` (the card when None) — the reference's Places365 stage
    (build_dataset:31-37 invokes an external run_placesCNN_cut.py over a
    Places365 CNN).

    ``io_map_path``: text file with one entry per class, 1 = indoor,
    2 = outdoor (the format of the official Places365 ``IO_places365.txt``;
    a bare 0/1 column with 1 = indoor also works). Classification: PIL's
    resize to ``input_size``² (as witw_tpu's), ImageNet-normalize on the
    device, argmax class -> indoor flag.
    """
    device = resolve_device(device)
    model = load_full_module(checkpoint_path, device)
    flags = []
    with open(io_map_path) as f:
        for line in f:
            parts = line.split()
            if parts:
                flags.append(int(parts[-1]) == 1)  # 1 = indoor in IO_places365.txt
    io_flags = np.asarray(flags, bool)
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)

    @torch.no_grad()
    def is_indoor(photo_path: str) -> bool:
        try:
            from PIL import Image

            with Image.open(photo_path) as im:
                img = np.asarray(im.convert("RGB").resize((input_size, input_size)), np.float32)
        except Exception:
            return True  # unreadable photos are dropped
        x = (torch.from_numpy(img).to(device) / 255.0 - mean) / std
        logits = model(x.permute(2, 0, 1)[None].contiguous())
        cls = int(torch.argmax(logits.reshape(-1)))
        return bool(io_flags[cls]) if cls < len(io_flags) else False

    return is_indoor


def build(
    metadata_root: str,
    photo_dir: str,
    sat_dir: str,
    out_dir: str,
    edge: float = 225.0,
    blank_threshold: float = 0.05,
    remove_ids: Optional[Iterable[str]] = None,
    indoor_classifier: Optional[Callable[[str], bool]] = None,
    verbose: bool = True,
    device=None,
    stage_seconds: Optional[Dict[str, float]] = None,
) -> Table:
    """Run stages 1-8 into ``out_dir``; returns the dataset table. The blank
    filter counts on ``device`` (the card when None). ``stage_seconds``, when
    given, receives each stage's wall time."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(os.path.join(out_dir, "surface"), exist_ok=True)
    clock = [time.perf_counter()]

    def log(stage, msg):
        now = time.perf_counter()
        if stage_seconds is not None:
            stage_seconds[stage] = now - clock[0]
        clock[0] = now
        if verbose:
            print(msg)

    # 1. CSV from metadata
    table = tiles.build_csv(metadata_root, os.path.join(out_dir, "dataset.csv"))
    log("1", f"stage 1: {table_len(table)} photos from metadata")

    # 2. single-band filter
    def photo_path(row):
        direct = os.path.join(photo_dir, row["aoi"], f"{row['id']}.jpg")
        if os.path.exists(direct):
            return direct
        # the downloaders (flickr/uploader.download_local, lambda_handler)
        # save under the URL basename ({id}_{secret}_x.jpg) — the reference
        # resolves photos the same way (build_dataset:65-70 copies
        # $flickr_folder/$aoi/$url_basename to surface/$id.jpg)
        url = str(row.get("url", "") or "")
        if url:
            return os.path.join(photo_dir, row["aoi"], url.rsplit("/", 1)[-1])
        return direct

    keep = [os.path.exists(photo_path(row)) and not is_single_band(photo_path(row))
            for row in iter_rows(table)]
    table = take_rows(table, np.asarray(keep, bool))
    log("2", f"stage 2: {table_len(table)} after single-band/existence filter")

    # 3. indoor filter (pluggable; reference uses Places365)
    if indoor_classifier is not None:
        keep = [not indoor_classifier(photo_path(row)) for row in iter_rows(table)]
        table = take_rows(table, np.asarray(keep, bool))
        log("3", f"stage 3: {table_len(table)} after indoor filter")

    # 4. preset removals
    if remove_ids:
        table = filter_frame(table, remove_ids, mode="remove")
        log("4", f"stage 4: {table_len(table)} after preset removals")

    # 5. tile clipping
    table = tiles.clip_tiles(table, sat_dir, out_dir, edge=edge)
    log("5", f"stage 5: {table_len(table)} tiles clipped")

    # 6. blank-tile filter
    keep = []
    for row in iter_rows(table):
        with GeoTiff(os.path.join(out_dir, row["overhead_path"])) as tif:
            keep.append(zero_fraction(tif.read(), device=device) <= blank_threshold)
    table = take_rows(table, np.asarray(keep, bool))
    log("6", f"stage 6: {table_len(table)} after blank filter")

    # copy surface photos into layout
    for row in iter_rows(table):
        src = photo_path(row)
        dst = os.path.join(out_dir, row["surface_path"])
        if os.path.exists(src) and not os.path.exists(dst):
            shutil.copyfile(src, dst)

    # 7-8. split + write
    train, test = tiles.split_train_test(table)
    write_table(os.path.join(out_dir, "dataset.csv"), table)
    write_table(os.path.join(out_dir, "train.csv"), train)
    write_table(os.path.join(out_dir, "test.csv"), test)
    log("7-8", f"stage 7-8: {table_len(train)} train / {table_len(test)} test rows written")
    return table


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build the WITW dataset")
    parser.add_argument("--metadata-root", required=True)
    parser.add_argument("--photo-dir", required=True)
    parser.add_argument("--sat-dir", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--edge", type=float, default=225.0)
    parser.add_argument("--blank-threshold", type=float, default=0.05)
    parser.add_argument("--remove-ids", default=None, help="file with ids to drop")
    parser.add_argument(
        "--places-checkpoint", default=None,
        help="torch scene-classifier checkpoint (full nn.Module, e.g. "
             "Places365; unpickled with weights_only=False) for the "
             "indoor-photo filter stage",
    )
    parser.add_argument(
        "--places-io-map", default=None,
        help="per-class indoor/outdoor map (IO_places365.txt format; "
             "required with --places-checkpoint)",
    )
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run on the host)")
    args = parser.parse_args(argv)
    remove_ids = load_id_set(args.remove_ids) if args.remove_ids else None
    indoor = None
    if args.places_checkpoint:
        if not args.places_io_map:
            parser.error("--places-checkpoint requires --places-io-map")
        indoor = torch_indoor_classifier(args.places_checkpoint, args.places_io_map,
                                         device=args.device)
    build(
        args.metadata_root, args.photo_dir, args.sat_dir, args.out_dir,
        edge=args.edge, blank_threshold=args.blank_threshold, remove_ids=remove_ids,
        indoor_classifier=indoor, device=args.device,
    )


if __name__ == "__main__":
    main()
