# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: hashdb.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0chashdb.proto\x12\thashdb.v1\x1a\x1bgoogle/protobuf/empty.proto\"\x19\n\x07Version\x12\x0e\n\x06v0_0_1\x18\x01 \x01(\t\"\xec\x01\n\nSetRequest\x12 \n\x08old_root\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x1b\n\x03key\x18\x02 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\r\n\x05value\x18\x03 \x01(\t\x12+\n\x0bpersistence\x18\x04 \x01(\x0e\x32\x16.hashdb.v1.Persistence\x12\x0f\n\x07\x64\x65tails\x18\x05 \x01(\x08\x12\x17\n\x0fget_db_read_log\x18\x06 \x01(\x08\x12\x12\n\nbatch_uuid\x18\x07 \x01(\t\x12\x10\n\x08tx_index\x18\x08 \x01(\x04\x12\x13\n\x0b\x62lock_index\x18\t \x01(\x04\"\x85\x01\n\nGetRequest\x12\x1c\n\x04root\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x1b\n\x03key\x18\x02 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x0f\n\x07\x64\x65tails\x18\x03 \x01(\x08\x12\x17\n\x0fget_db_read_log\x18\x04 \x01(\x08\x12\x12\n\nbatch_uuid\x18\x05 \x01(\t\"\xa6\x01\n\x11SetProgramRequest\x12\x1b\n\x03key\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\x12+\n\x0bpersistence\x18\x03 \x01(\x0e\x32\x16.hashdb.v1.Persistence\x12\x12\n\nbatch_uuid\x18\x04 \x01(\t\x12\x10\n\x08tx_index\x18\x05 \x01(\x04\x12\x13\n\x0b\x62lock_index\x18\x06 \x01(\x04\"D\n\x11GetProgramRequest\x12\x1b\n\x03key\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x12\n\nbatch_uuid\x18\x02 \x01(\t\"\xc3\x01\n\rLoadDBRequest\x12\x37\n\x08input_db\x18\x01 \x03(\x0b\x32%.hashdb.v1.LoadDBRequest.InputDbEntry\x12\x12\n\npersistent\x18\x02 \x01(\x08\x12\"\n\nstate_root\x18\x03 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x1a\x41\n\x0cInputDbEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12 \n\x05value\x18\x02 \x01(\x0b\x32\x11.hashdb.v1.FeList:\x02\x38\x01\"\xb0\x01\n\x14LoadProgramDBRequest\x12M\n\x10input_program_db\x18\x01 \x03(\x0b\x32\x33.hashdb.v1.LoadProgramDBRequest.InputProgramDbEntry\x12\x12\n\npersistent\x18\x02 \x01(\x08\x1a\x35\n\x13InputProgramDbEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\"g\n\x0c\x46lushRequest\x12\x12\n\nbatch_uuid\x18\x01 \x01(\t\x12\x16\n\x0enew_state_root\x18\x02 \x01(\t\x12+\n\x0bpersistence\x18\x03 \x01(\x0e\x32\x16.hashdb.v1.Persistence\"j\n\x0f\x46inishTxRequest\x12\x12\n\nbatch_uuid\x18\x01 \x01(\t\x12\x16\n\x0enew_state_root\x18\x02 \x01(\t\x12+\n\x0bpersistence\x18\x03 \x01(\x0e\x32\x16.hashdb.v1.Persistence\"l\n\x11StartBlockRequest\x12\x12\n\nbatch_uuid\x18\x01 \x01(\t\x12\x16\n\x0eold_state_root\x18\x02 \x01(\t\x12+\n\x0bpersistence\x18\x03 \x01(\x0e\x32\x16.hashdb.v1.Persistence\"m\n\x12\x46inishBlockRequest\x12\x12\n\nbatch_uuid\x18\x01 \x01(\t\x12\x16\n\x0enew_state_root\x18\x02 \x01(\t\x12+\n\x0bpersistence\x18\x03 \x01(\x0e\x32\x16.hashdb.v1.Persistence\"\'\n\x13GetFlushDataRequest\x12\x10\n\x08\x66lush_id\x18\x01 \x01(\x04\"r\n\x17\x43onsolidateStateRequest\x12*\n\x12virtual_state_root\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12+\n\x0bpersistence\x18\x02 \x01(\x0e\x32\x16.hashdb.v1.Persistence\"w\n\x0cPurgeRequest\x12\x12\n\nbatch_uuid\x18\x01 \x01(\t\x12&\n\x0enew_state_root\x18\x02 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12+\n\x0bpersistence\x18\x03 \x01(\x0e\x32\x16.hashdb.v1.Persistence\"S\n\x0fReadTreeRequest\x12\"\n\nstate_root\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x1c\n\x04keys\x18\x02 \x03(\x0b\x32\x0e.hashdb.v1.Fea\"(\n\x12\x43\x61ncelBatchRequest\x12\x12\n\nbatch_uuid\x18\x01 \x01(\t\"h\n\x1aGetLatestStateRootResponse\x12#\n\x0blatest_root\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12%\n\x06result\x18\x02 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"\x85\x05\n\x0bSetResponse\x12 \n\x08old_root\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12 \n\x08new_root\x18\x02 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x1b\n\x03key\x18\x03 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x36\n\x08siblings\x18\x04 \x03(\x0b\x32$.hashdb.v1.SetResponse.SiblingsEntry\x12\x1f\n\x07ins_key\x18\x05 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x11\n\tins_value\x18\x06 \x01(\t\x12\x0f\n\x07is_old0\x18\x07 \x01(\x08\x12\x11\n\told_value\x18\x08 \x01(\t\x12\x11\n\tnew_value\x18\t \x01(\t\x12\x0c\n\x04mode\x18\n \x01(\t\x12\x1a\n\x12proof_hash_counter\x18\x0b \x01(\x04\x12:\n\x0b\x64\x62_read_log\x18\x0c \x03(\x0b\x32%.hashdb.v1.SetResponse.DbReadLogEntry\x12%\n\x06result\x18\r \x01(\x0b\x32\x15.hashdb.v1.ResultCode\x12*\n\x12sibling_left_child\x18\x0e \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12+\n\x13sibling_right_child\x18\x0f \x01(\x0b\x32\x0e.hashdb.v1.Fea\x1aG\n\rSiblingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.hashdb.v1.SiblingList:\x02\x38\x01\x1a\x43\n\x0e\x44\x62ReadLogEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12 \n\x05value\x18\x02 \x01(\x0b\x32\x11.hashdb.v1.FeList:\x02\x38\x01\"\xe1\x03\n\x0bGetResponse\x12\x1c\n\x04root\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x1b\n\x03key\x18\x02 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x36\n\x08siblings\x18\x03 \x03(\x0b\x32$.hashdb.v1.GetResponse.SiblingsEntry\x12\x1f\n\x07ins_key\x18\x04 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x11\n\tins_value\x18\x05 \x01(\t\x12\x0f\n\x07is_old0\x18\x06 \x01(\x08\x12\r\n\x05value\x18\x07 \x01(\t\x12\x1a\n\x12proof_hash_counter\x18\x08 \x01(\x04\x12:\n\x0b\x64\x62_read_log\x18\t \x03(\x0b\x32%.hashdb.v1.GetResponse.DbReadLogEntry\x12%\n\x06result\x18\n \x01(\x0b\x32\x15.hashdb.v1.ResultCode\x1aG\n\rSiblingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.hashdb.v1.SiblingList:\x02\x38\x01\x1a\x43\n\x0e\x44\x62ReadLogEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12 \n\x05value\x18\x02 \x01(\x0b\x32\x11.hashdb.v1.FeList:\x02\x38\x01\";\n\x12SetProgramResponse\x12%\n\x06result\x18\x01 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"I\n\x12GetProgramResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12%\n\x06result\x18\x02 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"a\n\rFlushResponse\x12\x10\n\x08\x66lush_id\x18\x01 \x01(\x04\x12\x17\n\x0fstored_flush_id\x18\x02 \x01(\x04\x12%\n\x06result\x18\x03 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"\xe7\x01\n\x16GetFlushStatusResponse\x12\x17\n\x0fstored_flush_id\x18\x01 \x01(\x04\x12\x18\n\x10storing_flush_id\x18\x02 \x01(\x04\x12\x15\n\rlast_flush_id\x18\x03 \x01(\x04\x12\x1e\n\x16pending_to_flush_nodes\x18\x04 \x01(\x04\x12 \n\x18pending_to_flush_program\x18\x05 \x01(\x04\x12\x15\n\rstoring_nodes\x18\x06 \x01(\x04\x12\x17\n\x0fstoring_program\x18\x07 \x01(\x04\x12\x11\n\tprover_id\x18\x08 \x01(\t\"\xc8\x02\n\x14GetFlushDataResponse\x12\x17\n\x0fstored_flush_id\x18\x01 \x01(\x04\x12\x39\n\x05nodes\x18\x02 \x03(\x0b\x32*.hashdb.v1.GetFlushDataResponse.NodesEntry\x12=\n\x07program\x18\x03 \x03(\x0b\x32,.hashdb.v1.GetFlushDataResponse.ProgramEntry\x12\x18\n\x10nodes_state_root\x18\x04 \x01(\t\x12%\n\x06result\x18\x05 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\x1a,\n\nNodesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a.\n\x0cProgramEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x9d\x01\n\x18\x43onsolidateStateResponse\x12/\n\x17\x63onsolidated_state_root\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x10\n\x08\x66lush_id\x18\x02 \x01(\x04\x12\x17\n\x0fstored_flush_id\x18\x03 \x01(\x04\x12%\n\x06result\x18\x04 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"6\n\rPurgeResponse\x12%\n\x06result\x18\x01 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"\x8d\x01\n\x10ReadTreeResponse\x12&\n\tkey_value\x18\x01 \x03(\x0b\x32\x13.hashdb.v1.KeyValue\x12*\n\nhash_value\x18\x02 \x03(\x0b\x32\x16.hashdb.v1.HashValueGL\x12%\n\x06result\x18\x03 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"<\n\x13\x43\x61ncelBatchResponse\x12%\n\x06result\x18\x01 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"8\n\x0fResetDBResponse\x12%\n\x06result\x18\x01 \x01(\x0b\x32\x15.hashdb.v1.ResultCode\"9\n\x03\x46\x65\x61\x12\x0b\n\x03\x66\x65\x30\x18\x01 \x01(\x04\x12\x0b\n\x03\x66\x65\x31\x18\x02 \x01(\x04\x12\x0b\n\x03\x66\x65\x32\x18\x03 \x01(\x04\x12\x0b\n\x03\x66\x65\x33\x18\x04 \x01(\x04\"\xa5\x01\n\x05\x46\x65\x61\x31\x32\x12\x0b\n\x03\x66\x65\x30\x18\x01 \x01(\x04\x12\x0b\n\x03\x66\x65\x31\x18\x02 \x01(\x04\x12\x0b\n\x03\x66\x65\x32\x18\x03 \x01(\x04\x12\x0b\n\x03\x66\x65\x33\x18\x04 \x01(\x04\x12\x0b\n\x03\x66\x65\x34\x18\x05 \x01(\x04\x12\x0b\n\x03\x66\x65\x35\x18\x06 \x01(\x04\x12\x0b\n\x03\x66\x65\x36\x18\x07 \x01(\x04\x12\x0b\n\x03\x66\x65\x37\x18\x08 \x01(\x04\x12\x0b\n\x03\x66\x65\x38\x18\t \x01(\x04\x12\x0b\n\x03\x66\x65\x39\x18\n \x01(\x04\x12\x0c\n\x04\x66\x65\x31\x30\x18\x0b \x01(\x04\x12\x0c\n\x04\x66\x65\x31\x31\x18\x0c \x01(\x04\"L\n\x0bHashValueGL\x12\x1c\n\x04hash\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\x1f\n\x05value\x18\x02 \x01(\x0b\x32\x10.hashdb.v1.Fea12\"6\n\x08KeyValue\x12\x1b\n\x03key\x18\x01 \x01(\x0b\x32\x0e.hashdb.v1.Fea\x12\r\n\x05value\x18\x02 \x01(\t\"\x14\n\x06\x46\x65List\x12\n\n\x02\x66\x65\x18\x01 \x03(\x04\"\x1e\n\x0bSiblingList\x12\x0f\n\x07sibling\x18\x01 \x03(\x04\"\xce\x01\n\nResultCode\x12(\n\x04\x63ode\x18\x01 \x01(\x0e\x32\x1a.hashdb.v1.ResultCode.Code\"\x95\x01\n\x04\x43ode\x12\x14\n\x10\x43ODE_UNSPECIFIED\x10\x00\x12\x10\n\x0c\x43ODE_SUCCESS\x10\x01\x12\x19\n\x15\x43ODE_DB_KEY_NOT_FOUND\x10\x02\x12\x11\n\rCODE_DB_ERROR\x10\x03\x12\x17\n\x13\x43ODE_INTERNAL_ERROR\x10\x04\x12\x1e\n\x1a\x43ODE_SMT_INVALID_DATA_SIZE\x10\x0e*e\n\x0bPersistence\x12!\n\x1dPERSISTENCE_CACHE_UNSPECIFIED\x10\x00\x12\x18\n\x14PERSISTENCE_DATABASE\x10\x01\x12\x19\n\x15PERSISTENCE_TEMPORARY\x10\x02\x32\x9f\n\n\rHashDBService\x12U\n\x12GetLatestStateRoot\x12\x16.google.protobuf.Empty\x1a%.hashdb.v1.GetLatestStateRootResponse\"\x00\x12\x36\n\x03Set\x12\x15.hashdb.v1.SetRequest\x1a\x16.hashdb.v1.SetResponse\"\x00\x12\x36\n\x03Get\x12\x15.hashdb.v1.GetRequest\x1a\x16.hashdb.v1.GetResponse\"\x00\x12K\n\nSetProgram\x12\x1c.hashdb.v1.SetProgramRequest\x1a\x1d.hashdb.v1.SetProgramResponse\"\x00\x12K\n\nGetProgram\x12\x1c.hashdb.v1.GetProgramRequest\x1a\x1d.hashdb.v1.GetProgramResponse\"\x00\x12<\n\x06LoadDB\x12\x18.hashdb.v1.LoadDBRequest\x1a\x16.google.protobuf.Empty\"\x00\x12J\n\rLoadProgramDB\x12\x1f.hashdb.v1.LoadProgramDBRequest\x1a\x16.google.protobuf.Empty\"\x00\x12@\n\x08\x46inishTx\x12\x1a.hashdb.v1.FinishTxRequest\x1a\x16.google.protobuf.Empty\"\x00\x12\x44\n\nStartBlock\x12\x1c.hashdb.v1.StartBlockRequest\x1a\x16.google.protobuf.Empty\"\x00\x12\x46\n\x0b\x46inishBlock\x12\x1d.hashdb.v1.FinishBlockRequest\x1a\x16.google.protobuf.Empty\"\x00\x12<\n\x05\x46lush\x12\x17.hashdb.v1.FlushRequest\x1a\x18.hashdb.v1.FlushResponse\"\x00\x12M\n\x0eGetFlushStatus\x12\x16.google.protobuf.Empty\x1a!.hashdb.v1.GetFlushStatusResponse\"\x00\x12Q\n\x0cGetFlushData\x12\x1e.hashdb.v1.GetFlushDataRequest\x1a\x1f.hashdb.v1.GetFlushDataResponse\"\x00\x12]\n\x10\x43onsolidateState\x12\".hashdb.v1.ConsolidateStateRequest\x1a#.hashdb.v1.ConsolidateStateResponse\"\x00\x12<\n\x05Purge\x12\x17.hashdb.v1.PurgeRequest\x1a\x18.hashdb.v1.PurgeResponse\"\x00\x12\x45\n\x08ReadTree\x12\x1a.hashdb.v1.ReadTreeRequest\x1a\x1b.hashdb.v1.ReadTreeResponse\"\x00\x12N\n\x0b\x43\x61ncelBatch\x12\x1d.hashdb.v1.CancelBatchRequest\x1a\x1e.hashdb.v1.CancelBatchResponse\"\x00\x12?\n\x07ResetDB\x12\x16.google.protobuf.Empty\x1a\x1a.hashdb.v1.ResetDBResponse\"\x00\x42\x39Z7github.com/0xPolygonHermez/zkevm-node/merkletree/hashdbb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'hashdb_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z7github.com/0xPolygonHermez/zkevm-node/merkletree/hashdb'
  _LOADDBREQUEST_INPUTDBENTRY._options = None
  _LOADDBREQUEST_INPUTDBENTRY._serialized_options = b'8\001'
  _LOADPROGRAMDBREQUEST_INPUTPROGRAMDBENTRY._options = None
  _LOADPROGRAMDBREQUEST_INPUTPROGRAMDBENTRY._serialized_options = b'8\001'
  _SETRESPONSE_SIBLINGSENTRY._options = None
  _SETRESPONSE_SIBLINGSENTRY._serialized_options = b'8\001'
  _SETRESPONSE_DBREADLOGENTRY._options = None
  _SETRESPONSE_DBREADLOGENTRY._serialized_options = b'8\001'
  _GETRESPONSE_SIBLINGSENTRY._options = None
  _GETRESPONSE_SIBLINGSENTRY._serialized_options = b'8\001'
  _GETRESPONSE_DBREADLOGENTRY._options = None
  _GETRESPONSE_DBREADLOGENTRY._serialized_options = b'8\001'
  _GETFLUSHDATARESPONSE_NODESENTRY._options = None
  _GETFLUSHDATARESPONSE_NODESENTRY._serialized_options = b'8\001'
  _GETFLUSHDATARESPONSE_PROGRAMENTRY._options = None
  _GETFLUSHDATARESPONSE_PROGRAMENTRY._serialized_options = b'8\001'
  _PERSISTENCE._serialized_start=5055
  _PERSISTENCE._serialized_end=5156
  _VERSION._serialized_start=56
  _VERSION._serialized_end=81
  _SETREQUEST._serialized_start=84
  _SETREQUEST._serialized_end=320
  _GETREQUEST._serialized_start=323
  _GETREQUEST._serialized_end=456
  _SETPROGRAMREQUEST._serialized_start=459
  _SETPROGRAMREQUEST._serialized_end=625
  _GETPROGRAMREQUEST._serialized_start=627
  _GETPROGRAMREQUEST._serialized_end=695
  _LOADDBREQUEST._serialized_start=698
  _LOADDBREQUEST._serialized_end=893
  _LOADDBREQUEST_INPUTDBENTRY._serialized_start=828
  _LOADDBREQUEST_INPUTDBENTRY._serialized_end=893
  _LOADPROGRAMDBREQUEST._serialized_start=896
  _LOADPROGRAMDBREQUEST._serialized_end=1072
  _LOADPROGRAMDBREQUEST_INPUTPROGRAMDBENTRY._serialized_start=1019
  _LOADPROGRAMDBREQUEST_INPUTPROGRAMDBENTRY._serialized_end=1072
  _FLUSHREQUEST._serialized_start=1074
  _FLUSHREQUEST._serialized_end=1177
  _FINISHTXREQUEST._serialized_start=1179
  _FINISHTXREQUEST._serialized_end=1285
  _STARTBLOCKREQUEST._serialized_start=1287
  _STARTBLOCKREQUEST._serialized_end=1395
  _FINISHBLOCKREQUEST._serialized_start=1397
  _FINISHBLOCKREQUEST._serialized_end=1506
  _GETFLUSHDATAREQUEST._serialized_start=1508
  _GETFLUSHDATAREQUEST._serialized_end=1547
  _CONSOLIDATESTATEREQUEST._serialized_start=1549
  _CONSOLIDATESTATEREQUEST._serialized_end=1663
  _PURGEREQUEST._serialized_start=1665
  _PURGEREQUEST._serialized_end=1784
  _READTREEREQUEST._serialized_start=1786
  _READTREEREQUEST._serialized_end=1869
  _CANCELBATCHREQUEST._serialized_start=1871
  _CANCELBATCHREQUEST._serialized_end=1911
  _GETLATESTSTATEROOTRESPONSE._serialized_start=1913
  _GETLATESTSTATEROOTRESPONSE._serialized_end=2017
  _SETRESPONSE._serialized_start=2020
  _SETRESPONSE._serialized_end=2665
  _SETRESPONSE_SIBLINGSENTRY._serialized_start=2525
  _SETRESPONSE_SIBLINGSENTRY._serialized_end=2596
  _SETRESPONSE_DBREADLOGENTRY._serialized_start=2598
  _SETRESPONSE_DBREADLOGENTRY._serialized_end=2665
  _GETRESPONSE._serialized_start=2668
  _GETRESPONSE._serialized_end=3149
  _GETRESPONSE_SIBLINGSENTRY._serialized_start=2525
  _GETRESPONSE_SIBLINGSENTRY._serialized_end=2596
  _GETRESPONSE_DBREADLOGENTRY._serialized_start=2598
  _GETRESPONSE_DBREADLOGENTRY._serialized_end=2665
  _SETPROGRAMRESPONSE._serialized_start=3151
  _SETPROGRAMRESPONSE._serialized_end=3210
  _GETPROGRAMRESPONSE._serialized_start=3212
  _GETPROGRAMRESPONSE._serialized_end=3285
  _FLUSHRESPONSE._serialized_start=3287
  _FLUSHRESPONSE._serialized_end=3384
  _GETFLUSHSTATUSRESPONSE._serialized_start=3387
  _GETFLUSHSTATUSRESPONSE._serialized_end=3618
  _GETFLUSHDATARESPONSE._serialized_start=3621
  _GETFLUSHDATARESPONSE._serialized_end=3949
  _GETFLUSHDATARESPONSE_NODESENTRY._serialized_start=3857
  _GETFLUSHDATARESPONSE_NODESENTRY._serialized_end=3901
  _GETFLUSHDATARESPONSE_PROGRAMENTRY._serialized_start=3903
  _GETFLUSHDATARESPONSE_PROGRAMENTRY._serialized_end=3949
  _CONSOLIDATESTATERESPONSE._serialized_start=3952
  _CONSOLIDATESTATERESPONSE._serialized_end=4109
  _PURGERESPONSE._serialized_start=4111
  _PURGERESPONSE._serialized_end=4165
  _READTREERESPONSE._serialized_start=4168
  _READTREERESPONSE._serialized_end=4309
  _CANCELBATCHRESPONSE._serialized_start=4311
  _CANCELBATCHRESPONSE._serialized_end=4371
  _RESETDBRESPONSE._serialized_start=4373
  _RESETDBRESPONSE._serialized_end=4429
  _FEA._serialized_start=4431
  _FEA._serialized_end=4488
  _FEA12._serialized_start=4491
  _FEA12._serialized_end=4656
  _HASHVALUEGL._serialized_start=4658
  _HASHVALUEGL._serialized_end=4734
  _KEYVALUE._serialized_start=4736
  _KEYVALUE._serialized_end=4790
  _FELIST._serialized_start=4792
  _FELIST._serialized_end=4812
  _SIBLINGLIST._serialized_start=4814
  _SIBLINGLIST._serialized_end=4844
  _RESULTCODE._serialized_start=4847
  _RESULTCODE._serialized_end=5053
  _RESULTCODE_CODE._serialized_start=4904
  _RESULTCODE_CODE._serialized_end=5053
  _HASHDBSERVICE._serialized_start=5159
  _HASHDBSERVICE._serialized_end=6470
# @@protoc_insertion_point(module_scope)
