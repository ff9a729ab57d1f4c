"""The env messages (own copy of dotaclient_tpu/protos/worldstate.proto and
dotaservice.proto) as pure-Python proto3 classes: the same fields, field
numbers, enums and wire bytes as the protoc-generated modules, with no
`google.protobuf` (protos/message.py holds the codec)."""
