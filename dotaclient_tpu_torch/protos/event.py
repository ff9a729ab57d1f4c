"""TensorBoard's event records (tensorflow/core/util/event.proto and
framework/summary.proto), the subset a scalar log writes: Event with its
wall time, step, file version and summary; Summary; Summary.Value with a
tag and a simple value. Field numbers and wire bytes are TensorBoard's, so
its readers load the files runtime/metrics.py writes."""

from __future__ import annotations

from dotaclient_tpu_torch.protos.message import Field, Message


class SummaryValue(Message):
    FIELDS = (
        Field(1, "tag", "string"),
        Field(2, "simple_value", "float", oneof="value"),
    )


class Summary(Message):
    Value = SummaryValue
    FIELDS = (Field(1, "value", SummaryValue, repeated=True),)


class Event(Message):
    FIELDS = (
        Field(1, "wall_time", "double"),
        Field(2, "step", "int64"),
        Field(3, "file_version", "string", oneof="what"),
        Field(5, "summary", Summary, oneof="what"),
    )
