"""The external-detector layer of deva_tpu_torch: MobileSAM and Light-HQ-SAM
as torch modules (tiny_vit, sam_decoder, mobile_sam), the detector adapters
and fusion functions (detectors), the text and automatic frame processors
and the demos' flags. Port of deva_tpu/ext/."""
