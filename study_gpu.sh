#!/bin/bash
# The detection-level study through the PyTorch port on one GPU: learnable
# synthetic trees -> training -> evaluation -> box-level match, for VoD and
# TJ4D, each model trained through the gather view and the polar view.
#
#   bash study_gpu.sh [WORK] [OUT]
#
# WORK (default _study) holds the trees, checkpoints and evaluations; OUT
# (default WORK/report) gets the logs, the match reports, the result.pkl
# files and summary.json. Steps:
#   1. trees: 96-frame VoD and TJ4D (64 train / 32 val) and the 256-frame
#      graded-support hard-val sets (tools/make_study_data.py);
#   2. VoD: train configs/hgsfusion_vod.yaml and hgsfusion_vod_polar.yaml
#      for 10 epochs (640 steps at B=1, --fix_random_seed) under torchrun;
#   3. the 2x2 cross evaluation: each checkpoint through each view;
#   4. hard-val: the gather checkpoint through both views (and the polar
#      checkpoint through both);
#   5. TJ4D: the same with hgsfusion_tj4d.yaml / hgsfusion_tj4d_polar.yaml at
#      --batch_size 1;
#   6. the box-level matches (tools/study_polar_match.py) and summary.json.
# The VoD gather checkpoint's hard-val evaluation also runs under the int8
# serving configs (hgsfusion_tpu_torch/configs/hgsfusion_vod_q8.yaml: F2V
# QUANT int8; hgsfusion_vod_w8a8.yaml: that and DDN QUANT w8a8), each
# matched against the bf16 gather evaluation. PARTS=vod_quant runs only the
# trees, the VoD gather training and those three evaluations and matches.
set -u
cd "$(dirname "$0")"
W=${1:-_study}
O=${2:-$W/report}
NPROC=${NPROC:-1}
EPOCHS=${EPOCHS:-10}
PARTS=${PARTS:-all}
mkdir -p "$W" "$O"
log() { echo "[study $(date +%H:%M:%S)] $*" | tee -a "$O/study.log"; }
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$O/card.txt" 2>&1
log "card: $(cat "$O/card.txt")"

log "trees"
python -m hgsfusion_tpu_torch.tools.make_study_data --root "$W" > "$O/trees.log" 2>&1 \
  || { log "TREES FAILED"; exit 1; }
python -m hgsfusion_tpu_torch.tools.make_study_data --root "$W" --hard_val \
  --num_frames 256 >> "$O/trees.log" 2>&1 || { log "HARD-VAL TREES FAILED"; exit 1; }

train() {  # name cfg tag data [extra args...]
  local name=$1 cfg=$2 tag=$3 data=$4; shift 4
  log "train $name"
  torchrun --standalone --nproc_per_node "$NPROC" -m hgsfusion_tpu_torch.tools.train \
    --cfg_file "$cfg" --extra_tag "$tag" --output_dir "$W/out" --epochs "$EPOCHS" \
    --workers 2 --fix_random_seed "$@" --set DATA_CONFIG.DATA_PATH "$data" \
    > "$O/train_$name.log" 2>&1 || log "TRAIN $name FAILED rc=$?"
}

eval_run() {  # cfg tag ckpt_dir data [extra --set pairs...]
  local cfg=$1 tag=$2 ck=$3 data=$4; shift 4
  log "eval $tag"
  python -m hgsfusion_tpu_torch.tools.test --cfg_file "$cfg" --extra_tag "$tag" \
    --output_dir "$W/eval" --ckpt_dir "$ck" --batch_size 1 --infer_time \
    --set DATA_CONFIG.DATA_PATH "$data" "$@" > "$O/eval_$tag.log" 2>&1 \
    || log "EVAL $tag FAILED rc=$?"
}

res() { echo "$W/eval/$1/$2/eval/result.pkl"; }
match() {  # a_tag_dir a_tag b_tag_dir b_tag out tree dataset
  python -m hgsfusion_tpu_torch.tools.study_polar_match --a "$(res "$1" "$2")" \
    --b "$(res "$3" "$4")" --infos "$W/$6/kitti_infos_val.pkl" --dataset "$7" \
    --json "$O/match_$5.json" > "$O/match_$5.log" 2>&1 || log "MATCH $5 FAILED rc=$?"
}

GV=hgsfusion_vod; PV=hgsfusion_vod_polar; GT=hgsfusion_tj4d; PT=hgsfusion_tj4d_polar
QV=hgsfusion_vod_q8; WV=hgsfusion_vod_w8a8; QDIR=hgsfusion_tpu_torch/configs
CKG=$W/out/$GV/study_g/ckpt; CKP=$W/out/$PV/study_p/ckpt
CKGT=$W/out/$GT/study_g/ckpt; CKPT=$W/out/$PT/study_p/ckpt

# ---- VoD
train vod_g configs/hgsfusion_vod.yaml study_g "$W/vod"
eval_run configs/hgsfusion_vod.yaml       hv_vod_g_gather "$CKG" "$W/vod_hardval"
eval_run $QDIR/$QV.yaml                    hv_vod_g_q8     "$CKG" "$W/vod_hardval"
eval_run $QDIR/$WV.yaml                    hv_vod_g_w8a8   "$CKG" "$W/vod_hardval"
match $GV hv_vod_g_gather $QV hv_vod_g_q8 hv_vod_g_q8 vod_hardval vod
match $GV hv_vod_g_gather $WV hv_vod_g_w8a8 hv_vod_g_w8a8 vod_hardval vod
if [ "$PARTS" = all ]; then
train vod_p configs/hgsfusion_vod_polar.yaml study_p "$W/vod"
eval_run configs/hgsfusion_vod.yaml       vod_g_gather "$CKG" "$W/vod"
eval_run configs/hgsfusion_vod_polar.yaml vod_g_polar  "$CKG" "$W/vod"
eval_run configs/hgsfusion_vod.yaml       vod_p_gather "$CKP" "$W/vod"
eval_run configs/hgsfusion_vod_polar.yaml vod_p_polar  "$CKP" "$W/vod"
eval_run configs/hgsfusion_vod_polar.yaml hv_vod_g_polar  "$CKG" "$W/vod_hardval"
eval_run configs/hgsfusion_vod.yaml       hv_vod_p_gather "$CKP" "$W/vod_hardval"
eval_run configs/hgsfusion_vod_polar.yaml hv_vod_p_polar  "$CKP" "$W/vod_hardval"

# ---- TJ4D (B=1, as the reference study)
train tj4d_g configs/hgsfusion_tj4d.yaml study_g "$W/tj4d" --batch_size 1
train tj4d_p configs/hgsfusion_tj4d_polar.yaml study_p "$W/tj4d" --batch_size 1
eval_run configs/hgsfusion_tj4d.yaml       tj4d_g_gather "$CKGT" "$W/tj4d"
eval_run configs/hgsfusion_tj4d_polar.yaml tj4d_g_polar  "$CKGT" "$W/tj4d"
eval_run configs/hgsfusion_tj4d.yaml       tj4d_p_gather "$CKPT" "$W/tj4d"
eval_run configs/hgsfusion_tj4d_polar.yaml tj4d_p_polar  "$CKPT" "$W/tj4d"
eval_run configs/hgsfusion_tj4d.yaml       hv_tj4d_g_gather "$CKGT" "$W/tj4d_hardval"
eval_run configs/hgsfusion_tj4d_polar.yaml hv_tj4d_g_polar  "$CKGT" "$W/tj4d_hardval"

# ---- box-level matches
log "matches"
match $GV vod_g_gather $PV vod_g_polar vod_g vod vod
match $GV vod_p_gather $PV vod_p_polar vod_p vod vod
match $GV vod_g_gather $GV vod_p_gather vod_xw vod vod
match $GV hv_vod_g_gather $PV hv_vod_g_polar hv_vod_g vod_hardval vod
match $GV hv_vod_p_gather $PV hv_vod_p_polar hv_vod_p vod_hardval vod
match $GT tj4d_g_gather $PT tj4d_g_polar tj4d_g tj4d tj4d
match $GT tj4d_p_gather $PT tj4d_p_polar tj4d_p tj4d tj4d
match $GT hv_tj4d_g_gather $PT hv_tj4d_g_polar hv_tj4d_g tj4d_hardval tj4d
fi

# ---- the result files, and the summary
for d in "$W"/eval/*/*/eval; do
  tag=$(basename "$(dirname "$d")")
  [ -f "$d/result.pkl" ] && cp "$d/result.pkl" "$O/result_$tag.pkl"
done
python - "$O" <<'PY' || log "SUMMARY FAILED"
import glob, json, os, re, sys
out = sys.argv[1]
summary = {"card": open(os.path.join(out, "card.txt")).read().strip(), "train": {},
           "eval": {}, "match": {}}
for path in sorted(glob.glob(os.path.join(out, "train_*.log"))):
    text = open(path).read()
    steps = {int(m.group(1)): float(m.group(2))
             for m in re.finditer(r"step (\d+)/\d+ loss ([0-9.]+)", text)}
    rate = re.findall(r"steps at ([0-9.]+) steps/s", text)
    summary["train"][os.path.basename(path)[len("train_"):-len(".log")]] = {
        "loss_by_step": steps, "steps_per_s": float(rate[-1]) if rate else None}
for path in sorted(glob.glob(os.path.join(out, "eval_*.log"))):
    text = open(path).read()
    ms = re.findall(r"inference \(pipelined\): ([0-9.]+) ms/frame", text)
    summary["eval"][os.path.basename(path)[len("eval_"):-len(".log")]] = {
        "pipelined_ms_per_frame": float(ms[-1]) if ms else None}
for path in sorted(glob.glob(os.path.join(out, "match_*.json"))):
    rep = json.load(open(path))
    keys = [k for k in rep["ap_a"] if k.endswith(("mAP_3d", "mAP_bev")) or "Overall" in k]
    summary["match"][os.path.basename(path)[len("match_"):-len(".json")]] = {
        "match_rate": {c: m["match_rate"] for c, m in rep["match"].items()},
        "iou_median": {c: m["iou_median"] for c, m in rep["match"].items()},
        "ap_a": {k: rep["ap_a"][k] for k in keys}, "ap_b": {k: rep["ap_b"][k] for k in keys},
        "dap": {k: rep["dap"][k] for k in keys}, "max_abs_dap": rep["max_abs_dap"]}
json.dump(summary, open(os.path.join(out, "summary.json"), "w"), indent=1)
print(json.dumps(summary)[:2000])
PY
log "STUDY DONE"
