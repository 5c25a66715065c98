"""Host-side planning pieces of the port: cost model, bucketing, bucket-weight
validation and the telemetry record."""
