"""Artifact signature (reference `srcs/utils/generate_signature.py:15-87`):
zip the artifacts directory, SHA1 the zip, write `signature.txt`.

Copy of `leaffliction_tpu/utils/signature.py`. Run from the directory that
holds `artifacts/`:

    python -m leaffliction_tpu_torch.utils.signature
"""

from __future__ import annotations

import hashlib
import zipfile
from pathlib import Path

from leaffliction_tpu_torch.core.logging import get_logger

LOGGER = get_logger(__name__)


class SignatureGenerator:
    def __init__(self, artifacts_dir: Path | str = "artifacts",
                 output_zip: Path | str = "artifacts.zip",
                 signature_file: Path | str = "signature.txt") -> None:
        self.artifacts_dir = Path(artifacts_dir)
        self.output_zip = Path(output_zip)
        self.signature_file = Path(signature_file)

    def create_zip(self) -> Path:
        if not self.artifacts_dir.exists():
            raise FileNotFoundError(
                f"Artifacts directory not found: {self.artifacts_dir}")
        with zipfile.ZipFile(self.output_zip, "w",
                             zipfile.ZIP_DEFLATED) as zf:
            for path in sorted(self.artifacts_dir.rglob("*")):
                if path.is_file():
                    zf.write(path, path.relative_to(self.artifacts_dir.parent))
        LOGGER.info("Created %s", self.output_zip)
        return self.output_zip

    def compute_sha1(self) -> str:
        sha1 = hashlib.sha1()
        with self.output_zip.open("rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                sha1.update(chunk)
        return sha1.hexdigest()

    def generate(self) -> str:
        self.create_zip()
        digest = self.compute_sha1()
        self.signature_file.write_text(digest + "\n", encoding="utf-8")
        LOGGER.info("Signature written to %s: %s", self.signature_file, digest)
        return digest


def main() -> None:
    from leaffliction_tpu_torch.core.logging import setup_logging

    setup_logging()
    SignatureGenerator().generate()


if __name__ == "__main__":
    main()
