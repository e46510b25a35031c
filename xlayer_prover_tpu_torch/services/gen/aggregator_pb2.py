# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: aggregator.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10\x61ggregator.proto\x12\raggregator.v1\"\x19\n\x07Version\x12\x0e\n\x06v0_0_1\x18\x01 \x01(\t\"\x9b\x04\n\x11\x41ggregatorMessage\x12\n\n\x02id\x18\x01 \x01(\t\x12=\n\x12get_status_request\x18\x02 \x01(\x0b\x32\x1f.aggregator.v1.GetStatusRequestH\x00\x12\x46\n\x17gen_batch_proof_request\x18\x03 \x01(\x0b\x32#.aggregator.v1.GenBatchProofRequestH\x00\x12P\n\x1cgen_aggregated_proof_request\x18\x04 \x01(\x0b\x32(.aggregator.v1.GenAggregatedProofRequestH\x00\x12\x46\n\x17gen_final_proof_request\x18\x05 \x01(\x0b\x32#.aggregator.v1.GenFinalProofRequestH\x00\x12\x36\n\x0e\x63\x61ncel_request\x18\x06 \x01(\x0b\x32\x1c.aggregator.v1.CancelRequestH\x00\x12;\n\x11get_proof_request\x18\x07 \x01(\x0b\x32\x1e.aggregator.v1.GetProofRequestH\x00\x12Y\n!gen_stateless_batch_proof_request\x18\x08 \x01(\x0b\x32,.aggregator.v1.GenStatelessBatchProofRequestH\x00\x42\t\n\x07request\"\xc9\x03\n\rProverMessage\x12\n\n\x02id\x18\x01 \x01(\t\x12?\n\x13get_status_response\x18\x02 \x01(\x0b\x32 .aggregator.v1.GetStatusResponseH\x00\x12H\n\x18gen_batch_proof_response\x18\x03 \x01(\x0b\x32$.aggregator.v1.GenBatchProofResponseH\x00\x12R\n\x1dgen_aggregated_proof_response\x18\x04 \x01(\x0b\x32).aggregator.v1.GenAggregatedProofResponseH\x00\x12H\n\x18gen_final_proof_response\x18\x05 \x01(\x0b\x32$.aggregator.v1.GenFinalProofResponseH\x00\x12\x38\n\x0f\x63\x61ncel_response\x18\x06 \x01(\x0b\x32\x1d.aggregator.v1.CancelResponseH\x00\x12=\n\x12get_proof_response\x18\x07 \x01(\x0b\x32\x1f.aggregator.v1.GetProofResponseH\x00\x42\n\n\x08response\"\x12\n\x10GetStatusRequest\"A\n\x14GenBatchProofRequest\x12)\n\x05input\x18\x01 \x01(\x0b\x32\x1a.aggregator.v1.InputProver\"S\n\x1dGenStatelessBatchProofRequest\x12\x32\n\x05input\x18\x01 \x01(\x0b\x32#.aggregator.v1.StatelessInputProver\"Q\n\x19GenAggregatedProofRequest\x12\x19\n\x11recursive_proof_1\x18\x01 \x01(\t\x12\x19\n\x11recursive_proof_2\x18\x02 \x01(\t\"H\n\x14GenFinalProofRequest\x12\x17\n\x0frecursive_proof\x18\x01 \x01(\t\x12\x17\n\x0f\x61ggregator_addr\x18\x02 \x01(\t\"\x1b\n\rCancelRequest\x12\n\n\x02id\x18\x01 \x01(\t\".\n\x0fGetProofRequest\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07timeout\x18\x02 \x01(\x04\"\x97\x04\n\x11GetStatusResponse\x12\x37\n\x06status\x18\x01 \x01(\x0e\x32\'.aggregator.v1.GetStatusResponse.Status\x12 \n\x18last_computed_request_id\x18\x02 \x01(\t\x12\x1e\n\x16last_computed_end_time\x18\x03 \x01(\x04\x12$\n\x1c\x63urrent_computing_request_id\x18\x04 \x01(\t\x12$\n\x1c\x63urrent_computing_start_time\x18\x05 \x01(\x04\x12\x15\n\rversion_proto\x18\x06 \x01(\t\x12\x16\n\x0eversion_server\x18\x07 \x01(\t\x12!\n\x19pending_request_queue_ids\x18\x08 \x03(\t\x12\x13\n\x0bprover_name\x18\t \x01(\t\x12\x11\n\tprover_id\x18\n \x01(\t\x12\x17\n\x0fnumber_of_cores\x18\x0b \x01(\x04\x12\x14\n\x0ctotal_memory\x18\x0c \x01(\x04\x12\x13\n\x0b\x66ree_memory\x18\r \x01(\x04\x12\x0f\n\x07\x66ork_id\x18\x0e \x01(\x04\"l\n\x06Status\x12\x16\n\x12STATUS_UNSPECIFIED\x10\x00\x12\x12\n\x0eSTATUS_BOOTING\x10\x01\x12\x14\n\x10STATUS_COMPUTING\x10\x02\x12\x0f\n\x0bSTATUS_IDLE\x10\x03\x12\x0f\n\x0bSTATUS_HALT\x10\x04\"J\n\x15GenBatchProofResponse\x12\n\n\x02id\x18\x01 \x01(\t\x12%\n\x06result\x18\x02 \x01(\x0e\x32\x15.aggregator.v1.Result\"O\n\x1aGenAggregatedProofResponse\x12\n\n\x02id\x18\x01 \x01(\t\x12%\n\x06result\x18\x02 \x01(\x0e\x32\x15.aggregator.v1.Result\"J\n\x15GenFinalProofResponse\x12\n\n\x02id\x18\x01 \x01(\t\x12%\n\x06result\x18\x02 \x01(\x0e\x32\x15.aggregator.v1.Result\"7\n\x0e\x43\x61ncelResponse\x12%\n\x06result\x18\x01 \x01(\x0e\x32\x15.aggregator.v1.Result\"\xef\x02\n\x10GetProofResponse\x12\n\n\x02id\x18\x01 \x01(\t\x12\x30\n\x0b\x66inal_proof\x18\x02 \x01(\x0b\x32\x19.aggregator.v1.FinalProofH\x00\x12\x19\n\x0frecursive_proof\x18\x03 \x01(\tH\x00\x12\x36\n\x06result\x18\x04 \x01(\x0e\x32&.aggregator.v1.GetProofResponse.Result\x12\x15\n\rresult_string\x18\x05 \x01(\t\"\xa9\x01\n\x06Result\x12\x16\n\x12RESULT_UNSPECIFIED\x10\x00\x12\x17\n\x13RESULT_COMPLETED_OK\x10\x01\x12\x10\n\x0cRESULT_ERROR\x10\x02\x12\x1a\n\x16RESULT_COMPLETED_ERROR\x10\x03\x12\x12\n\x0eRESULT_PENDING\x10\x04\x12\x19\n\x15RESULT_INTERNAL_ERROR\x10\x05\x12\x11\n\rRESULT_CANCEL\x10\x06\x42\x07\n\x05proof\"P\n\nFinalProof\x12\r\n\x05proof\x18\x01 \x01(\t\x12\x33\n\x06public\x18\x02 \x01(\x0b\x32#.aggregator.v1.PublicInputsExtended\"\xaa\x03\n\x0cPublicInputs\x12\x16\n\x0eold_state_root\x18\x01 \x01(\x0c\x12\x1a\n\x12old_acc_input_hash\x18\x02 \x01(\x0c\x12\x15\n\rold_batch_num\x18\x03 \x01(\x04\x12\x10\n\x08\x63hain_id\x18\x04 \x01(\x04\x12\x0f\n\x07\x66ork_id\x18\x05 \x01(\x04\x12\x15\n\rbatch_l2_data\x18\x06 \x01(\x0c\x12\x14\n\x0cl1_info_root\x18\x07 \x01(\x0c\x12\x17\n\x0ftimestamp_limit\x18\x08 \x01(\x04\x12\x16\n\x0esequencer_addr\x18\t \x01(\t\x12\x1b\n\x13\x66orced_blockhash_l1\x18\n \x01(\x0c\x12\x17\n\x0f\x61ggregator_addr\x18\x0c \x01(\t\x12J\n\x11l1_info_tree_data\x18\x10 \x03(\x0b\x32/.aggregator.v1.PublicInputs.L1InfoTreeDataEntry\x1aL\n\x13L1InfoTreeDataEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12$\n\x05value\x18\x02 \x01(\x0b\x32\x15.aggregator.v1.L1Data:\x02\x38\x01\"\xf9\x02\n\x15StatelessPublicInputs\x12\x0f\n\x07witness\x18\x01 \x01(\x0c\x12\x13\n\x0b\x64\x61ta_stream\x18\x02 \x01(\x0c\x12\x1a\n\x12old_acc_input_hash\x18\x03 \x01(\x0c\x12\x14\n\x0cl1_info_root\x18\x04 \x01(\x0c\x12\x17\n\x0ftimestamp_limit\x18\x05 \x01(\x04\x12\x16\n\x0esequencer_addr\x18\x06 \x01(\t\x12\x1b\n\x13\x66orced_blockhash_l1\x18\x07 \x01(\x0c\x12\x17\n\x0f\x61ggregator_addr\x18\x08 \x01(\t\x12S\n\x11l1_info_tree_data\x18\t \x03(\x0b\x32\x38.aggregator.v1.StatelessPublicInputs.L1InfoTreeDataEntry\x1aL\n\x13L1InfoTreeDataEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12$\n\x05value\x18\x02 \x01(\x0b\x32\x15.aggregator.v1.L1Data:\x02\x38\x01\"b\n\x06L1Data\x12\x18\n\x10global_exit_root\x18\x01 \x01(\x0c\x12\x14\n\x0c\x62lockhash_l1\x18\x02 \x01(\x0c\x12\x15\n\rmin_timestamp\x18\x03 \x01(\r\x12\x11\n\tsmt_proof\x18\x04 \x03(\x0c\"\xa5\x02\n\x0bInputProver\x12\x32\n\rpublic_inputs\x18\x01 \x01(\x0b\x32\x1b.aggregator.v1.PublicInputs\x12.\n\x02\x64\x62\x18\x04 \x03(\x0b\x32\".aggregator.v1.InputProver.DbEntry\x12M\n\x12\x63ontracts_bytecode\x18\x05 \x03(\x0b\x32\x31.aggregator.v1.InputProver.ContractsBytecodeEntry\x1a)\n\x07\x44\x62\x45ntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x38\n\x16\x43ontractsBytecodeEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"S\n\x14StatelessInputProver\x12;\n\rpublic_inputs\x18\x01 \x01(\x0b\x32$.aggregator.v1.StatelessPublicInputs\"\xb2\x01\n\x14PublicInputsExtended\x12\x32\n\rpublic_inputs\x18\x01 \x01(\x0b\x32\x1b.aggregator.v1.PublicInputs\x12\x16\n\x0enew_state_root\x18\x02 \x01(\x0c\x12\x1a\n\x12new_acc_input_hash\x18\x03 \x01(\x0c\x12\x1b\n\x13new_local_exit_root\x18\x04 \x01(\x0c\x12\x15\n\rnew_batch_num\x18\x05 \x01(\x04*\\\n\x06Result\x12\x16\n\x12RESULT_UNSPECIFIED\x10\x00\x12\r\n\tRESULT_OK\x10\x01\x12\x10\n\x0cRESULT_ERROR\x10\x02\x12\x19\n\x15RESULT_INTERNAL_ERROR\x10\x03\x32\x64\n\x11\x41ggregatorService\x12O\n\x07\x43hannel\x12\x1c.aggregator.v1.ProverMessage\x1a .aggregator.v1.AggregatorMessage\"\x00(\x01\x30\x01\x42;Z9github.com/0xPolygonHermez/zkevm-node/proverclient/proverb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'aggregator_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z9github.com/0xPolygonHermez/zkevm-node/proverclient/prover'
  _PUBLICINPUTS_L1INFOTREEDATAENTRY._options = None
  _PUBLICINPUTS_L1INFOTREEDATAENTRY._serialized_options = b'8\001'
  _STATELESSPUBLICINPUTS_L1INFOTREEDATAENTRY._options = None
  _STATELESSPUBLICINPUTS_L1INFOTREEDATAENTRY._serialized_options = b'8\001'
  _INPUTPROVER_DBENTRY._options = None
  _INPUTPROVER_DBENTRY._serialized_options = b'8\001'
  _INPUTPROVER_CONTRACTSBYTECODEENTRY._options = None
  _INPUTPROVER_CONTRACTSBYTECODEENTRY._serialized_options = b'8\001'
  _RESULT._serialized_start=4221
  _RESULT._serialized_end=4313
  _VERSION._serialized_start=35
  _VERSION._serialized_end=60
  _AGGREGATORMESSAGE._serialized_start=63
  _AGGREGATORMESSAGE._serialized_end=602
  _PROVERMESSAGE._serialized_start=605
  _PROVERMESSAGE._serialized_end=1062
  _GETSTATUSREQUEST._serialized_start=1064
  _GETSTATUSREQUEST._serialized_end=1082
  _GENBATCHPROOFREQUEST._serialized_start=1084
  _GENBATCHPROOFREQUEST._serialized_end=1149
  _GENSTATELESSBATCHPROOFREQUEST._serialized_start=1151
  _GENSTATELESSBATCHPROOFREQUEST._serialized_end=1234
  _GENAGGREGATEDPROOFREQUEST._serialized_start=1236
  _GENAGGREGATEDPROOFREQUEST._serialized_end=1317
  _GENFINALPROOFREQUEST._serialized_start=1319
  _GENFINALPROOFREQUEST._serialized_end=1391
  _CANCELREQUEST._serialized_start=1393
  _CANCELREQUEST._serialized_end=1420
  _GETPROOFREQUEST._serialized_start=1422
  _GETPROOFREQUEST._serialized_end=1468
  _GETSTATUSRESPONSE._serialized_start=1471
  _GETSTATUSRESPONSE._serialized_end=2006
  _GETSTATUSRESPONSE_STATUS._serialized_start=1898
  _GETSTATUSRESPONSE_STATUS._serialized_end=2006
  _GENBATCHPROOFRESPONSE._serialized_start=2008
  _GENBATCHPROOFRESPONSE._serialized_end=2082
  _GENAGGREGATEDPROOFRESPONSE._serialized_start=2084
  _GENAGGREGATEDPROOFRESPONSE._serialized_end=2163
  _GENFINALPROOFRESPONSE._serialized_start=2165
  _GENFINALPROOFRESPONSE._serialized_end=2239
  _CANCELRESPONSE._serialized_start=2241
  _CANCELRESPONSE._serialized_end=2296
  _GETPROOFRESPONSE._serialized_start=2299
  _GETPROOFRESPONSE._serialized_end=2666
  _GETPROOFRESPONSE_RESULT._serialized_start=2488
  _GETPROOFRESPONSE_RESULT._serialized_end=2657
  _FINALPROOF._serialized_start=2668
  _FINALPROOF._serialized_end=2748
  _PUBLICINPUTS._serialized_start=2751
  _PUBLICINPUTS._serialized_end=3177
  _PUBLICINPUTS_L1INFOTREEDATAENTRY._serialized_start=3101
  _PUBLICINPUTS_L1INFOTREEDATAENTRY._serialized_end=3177
  _STATELESSPUBLICINPUTS._serialized_start=3180
  _STATELESSPUBLICINPUTS._serialized_end=3557
  _STATELESSPUBLICINPUTS_L1INFOTREEDATAENTRY._serialized_start=3101
  _STATELESSPUBLICINPUTS_L1INFOTREEDATAENTRY._serialized_end=3177
  _L1DATA._serialized_start=3559
  _L1DATA._serialized_end=3657
  _INPUTPROVER._serialized_start=3660
  _INPUTPROVER._serialized_end=3953
  _INPUTPROVER_DBENTRY._serialized_start=3854
  _INPUTPROVER_DBENTRY._serialized_end=3895
  _INPUTPROVER_CONTRACTSBYTECODEENTRY._serialized_start=3897
  _INPUTPROVER_CONTRACTSBYTECODEENTRY._serialized_end=3953
  _STATELESSINPUTPROVER._serialized_start=3955
  _STATELESSINPUTPROVER._serialized_end=4038
  _PUBLICINPUTSEXTENDED._serialized_start=4041
  _PUBLICINPUTSEXTENDED._serialized_end=4219
  _AGGREGATORSERVICE._serialized_start=4315
  _AGGREGATORSERVICE._serialized_end=4415
# @@protoc_insertion_point(module_scope)
