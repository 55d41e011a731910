"""pw.io.minio — MinIO connector (reference: python/pathway/io/minio
MinIOSettings:15, read:59 — S3-compatible endpoint routed through the S3
scanner)."""

from __future__ import annotations

from pathway_tpu_torch.io.s3 import AwsS3Settings
from pathway_tpu_torch.io.s3 import read as _s3_read


class MinIOSettings:
    """(reference: io/minio MinIOSettings:15)"""

    def __init__(
        self,
        endpoint: str,
        bucket_name: str,
        access_key: str,
        secret_access_key: str,
        *,
        with_path_style: bool = True,
        region: str | None = None,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region

    def create_aws_settings(self) -> AwsS3Settings:
        endpoint = self.endpoint
        if not endpoint.startswith("http"):
            endpoint = f"https://{endpoint}"
        return AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            with_path_style=self.with_path_style,
            region=self.region,
            endpoint=endpoint,
        )


def read(
    path: str,
    minio_settings: MinIOSettings,
    *,
    format: str = "csv",
    schema=None,
    mode: str = "streaming",
    **kwargs,
):
    """Read from a MinIO bucket (reference: io/minio read:59)."""
    return _s3_read(
        path,
        aws_s3_settings=minio_settings.create_aws_settings(),
        format=format,
        schema=schema,
        mode=mode,
        **kwargs,
    )
