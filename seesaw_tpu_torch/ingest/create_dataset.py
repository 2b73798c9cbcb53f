"""Create a dataset directory from an image folder.

    python -m seesaw_tpu_torch.ingest.create_dataset --image_dir <images> \
        --output_path <dataset dir> [--force]

The twin of `scripts/create_dataset.py`, with its flags: the dataset
directory links the image folder as `images/` and lists its images, in
sorted order, in `file_meta.parquet` (`dataset.SeesawDataset.create`);
`--force` replaces a directory that exists.
"""
import argparse

from ..dataset import SeesawDataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--image_dir", required=True, help="folder with images")
    parser.add_argument("--output_path", required=True, help="dataset dir to create")
    parser.add_argument("--force", action="store_true")
    args = parser.parse_args(argv)
    ds = SeesawDataset.create(args.output_path, image_src=args.image_dir, force=args.force)
    print(f"created {ds} at {ds.path}")


if __name__ == "__main__":
    main()
